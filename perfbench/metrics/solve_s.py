"""solve_s: the whole window over the number of solves it finished (an
edge dict in, world poses out, packing included)."""


def read(run):
    calls = run["calls"]
    return (calls[-1][1] - calls[0][0]) / len(calls)
