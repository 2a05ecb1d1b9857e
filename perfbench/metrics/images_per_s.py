"""images_per_s: every frame of the captures that finished in the window,
over the host-clock time from the first capture's start to the last one's
end (each call returns a host dict, so the card is synchronized)."""


def read(run):
    calls = run["calls"]
    return sum(c[2] for c in calls) / (calls[-1][1] - calls[0][0])
