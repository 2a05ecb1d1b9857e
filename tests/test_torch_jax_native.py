"""The JAX package's C modules, built once per pytest worker before a port
test compares against them.

``vican_tpu._native`` compiles each module to one shared temporary name and
caches ``None`` for the rest of the process when its build fails.  Several
pytest workers building the same module at once can lose that race, and the
loser then runs the JAX package's pure-Python paths for its whole life.
The port's tests that compare against the JAX package take its C modules
through :func:`jax_native`: builds serialized by a file lock across workers,
a cached ``None`` dropped and the build asked again, and a clear failure if
a module is still missing.  Other test files import the fixture:

    from test_torch_jax_native import jax_native  # noqa: F401
"""
import fcntl
import os
import tempfile
import time

import pytest

import vican_tpu._native as jnative

MODULES = ("fastpack", "fastccl", "fastthresh")
ATTEMPTS = 10
_LOCK = os.path.join(tempfile.gettempdir(), "vican_tpu_native_build.lock")


def load_jax_native(names=MODULES, attempts=ATTEMPTS) -> dict:
    """The JAX package's compiled modules ``names``, each built under an
    exclusive lock; a cached ``None`` (a build lost to a concurrent one) is
    dropped and the build asked again, up to ``attempts`` times.  Raises
    ``RuntimeError`` naming the modules still missing."""
    getters = {"fastpack": jnative.get_fastpack, "fastccl": jnative.get_fastccl,
               "fastthresh": jnative.get_fastthresh}
    mods = {}
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for name in names:
                for attempt in range(attempts):
                    mods[name] = getters[name]()
                    if mods[name] is not None:
                        break
                    # the winner of a concurrent build renames its .so into
                    # place; the next call finds it and loads it
                    jnative._cache.pop(name, None)
                    time.sleep(0.2 * (attempt + 1))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    missing = [n for n, m in mods.items() if m is None]
    if missing:
        raise RuntimeError(f"the JAX package's C modules {missing} did not build in "
                           f"{attempts} attempts (VICAN_TPU_NO_NATIVE="
                           f"{os.environ.get('VICAN_TPU_NO_NATIVE')!r}, CC="
                           f"{os.environ.get('CC', 'gcc')!r})")
    return mods


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Every JAX C module built and cached in this worker before the
    module's tests and fixtures run; fails, never skips, when one is
    missing."""
    try:
        return load_jax_native()
    except RuntimeError as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("name", MODULES)
def test_jax_module_is_cached(jax_native, name):
    assert jax_native[name] is not None
    assert jnative._cache[name] is jax_native[name]


def test_cached_none_is_rebuilt():
    """A cached ``None``, as a worker that lost a build race holds, is
    dropped and the module loaded again."""
    jnative._cache["fastpack"] = None
    mods = load_jax_native(("fastpack",))
    assert mods["fastpack"] is not None and jnative._cache["fastpack"] is mods["fastpack"]


def test_missing_module_fails_clearly(monkeypatch):
    monkeypatch.setattr(jnative, "_cache", {})
    monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="fastccl"):
        load_jax_native(("fastccl",), attempts=2)
