"""Recognized noise-model / edge-filter forms for the packing fast path
(the port's copy of ``vican_tpu.solver.specs``).

The reference evaluates ``noise_model_r/t`` and ``edge_filter`` per edge in
a Python dict loop (reference vican/bipgo.py:203-223; the notebook's models
are ``scale * Polygon(corners).area ** power`` and
``reprojected_err < tau`` — main.ipynb cells 3/7).  Our C packer
(fastpack.c) already makes everything else single-pass, which leaves the
interpreter round-trips into these user callables as the dominant host
packing cost (~1 us/edge x 3 calls).

This module recognizes the canonical forms so the C packer can evaluate
them inline (zero interpreter calls per edge), bit-exactly:

1. **Declarative specs** — :class:`ConstNoise`, :class:`CornerAreaPower`,
   :class:`ReprojErrBelow`, :class:`KeepAll` are drop-in callables (they
   work anywhere the reference API takes a callable) that the packer
   detects by type.
2. **Closure recognition** — plain lambdas matching the tutorial /
   notebook shapes (``lambda e: 0.01 * polygon_area(e["corners"]) ** 2``,
   ``lambda e: e["reprojected_err"] < 0.05``, ``lambda e: 1.0``) are
   recognized by comparing their bytecode against templates compiled in
   this interpreter: identical ``co_code``/names/signature with only the
   constants differing is the *same function* up to those constants, so
   the rewrite is sound (no probabilistic probing).  ``polygon_area``
   must resolve to this package's function
   (``vican_torch.ops.shoelace.polygon_area``) for area forms to match.

The C evaluation replicates the Python float arithmetic operation-for-
operation (same shoelace term order as ops.shoelace.polygon_area's scalar
path, libm ``pow``), so recognized edges produce bit-identical ``k_r``/
``k_t``/filter decisions to calling the closure — pinned by
tests/test_torch_packing.py.  Unrecognized callables keep the per-edge call
path unchanged.
"""
from __future__ import annotations

from ..ops.shoelace import polygon_area

__all__ = [
    "ConstNoise",
    "CornerAreaPower",
    "ReprojErrBelow",
    "KeepAll",
    "recognize_noise",
    "recognize_filter",
]


class ConstNoise:
    """``lambda e: value`` as a declarative spec."""

    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, e):
        return self.value


class CornerAreaPower:
    """``lambda e: scale * polygon_area(e["corners"]) ** power``."""

    def __init__(self, scale: float = 1.0, power: float = 1.0):
        self.scale = float(scale)
        self.power = float(power)

    def __call__(self, e):
        return self.scale * polygon_area(e["corners"]) ** self.power


class ReprojErrBelow:
    """``lambda e: e["reprojected_err"] < tau``."""

    def __init__(self, tau: float):
        self.tau = float(tau)

    def __call__(self, e):
        return e["reprojected_err"] < self.tau


class KeepAll:
    """``lambda e: True``."""

    def __call__(self, e):
        return True


# --- closure recognition ---------------------------------------------------
#
# Templates are compiled HERE, in the running interpreter, so the bytecode
# comparison is version-proof.  Placeholder constants are improbable floats
# whose positions in co_consts tell us where to read the user's values.
_P1 = 8.5312946721e-07
_P2 = 5.2211347993e-11


def _const_positions(code, placeholders):
    """Positions of each placeholder value in ``code.co_consts`` (by ==)."""
    pos = []
    for p in placeholders:
        hits = [i for i, c in enumerate(code.co_consts)
                if isinstance(c, float) and c == p]
        if len(hits) != 1:
            raise AssertionError(
                f"template placeholder {p} found {len(hits)} times")
        pos.append(hits[0])
    return pos


class _Template:
    def __init__(self, fn, placeholders, build, needs_polygon_area=False):
        self.code = fn.__code__
        self.positions = _const_positions(self.code, placeholders)
        self.build = build
        self.needs_polygon_area = needs_polygon_area

    def match(self, fn):
        try:
            code = fn.__code__
        except AttributeError:
            return None
        t = self.code
        if (code.co_code != t.co_code
                or code.co_names != t.co_names
                or code.co_varnames != t.co_varnames
                or code.co_freevars != t.co_freevars
                or code.co_argcount != t.co_argcount
                or fn.__defaults__ is not None
                or getattr(fn, "__kwdefaults__", None)):
            return None
        # non-placeholder consts (dict keys like "corners") must be equal
        for i, (a, b) in enumerate(zip(code.co_consts, t.co_consts)):
            if i in self.positions:
                if not isinstance(a, (int, float)) or isinstance(a, bool):
                    return None
            elif a != b or type(a) is not type(b):
                return None
        if self.needs_polygon_area:
            # the `polygon_area` name must resolve to OUR polygon_area (an
            # alias or shadow breaks the match) — through the closure cell
            # when the template binds it as a freevar (the user imported it
            # locally), through globals otherwise
            if "polygon_area" in t.co_freevars:
                idx = code.co_freevars.index("polygon_area")
                cell = fn.__closure__[idx]
                if cell.cell_contents is not polygon_area:
                    return None
            elif fn.__globals__.get("polygon_area") is not polygon_area:
                return None
        return self.build(*(float(code.co_consts[i]) for i in self.positions))


def _freevar_area_templates():
    """Area templates whose ``polygon_area`` is a CLOSURE FREEVAR — matching
    user lambdas written where polygon_area was imported locally (inside a
    function) rather than at module scope."""
    from ..ops import shoelace

    polygon_area = shoelace.polygon_area  # local → freevar of the lambdas
    return [
        _Template(
            lambda e: 8.5312946721e-07 * polygon_area(e["corners"]) ** 5.2211347993e-11,
            (_P1, _P2),
            lambda s, p: ("area_pow", s, p),
            needs_polygon_area=True,
        ),
        _Template(
            lambda e: polygon_area(e["corners"]) ** 5.2211347993e-11,
            (_P2,),
            lambda p: ("area_pow", 1.0, p),
            needs_polygon_area=True,
        ),
    ]


def _make_templates():
    # area templates come in two bytecode variants: polygon_area as a module
    # GLOBAL (tutorial style) and as a closure FREEVAR (imported inside the
    # calling function) — _freevar_area_templates builds the latter
    noise = [
        _Template(
            lambda e: 8.5312946721e-07 * polygon_area(e["corners"]) ** 5.2211347993e-11,
            (_P1, _P2),
            lambda s, p: ("area_pow", s, p),
            needs_polygon_area=True,
        ),
        _Template(
            lambda e: polygon_area(e["corners"]) ** 5.2211347993e-11,
            (_P2,),
            lambda p: ("area_pow", 1.0, p),
            needs_polygon_area=True,
        ),
        *_freevar_area_templates(),
        _Template(
            lambda e: 8.5312946721e-07,
            (_P1,),
            lambda c: ("const", c),
        ),
    ]
    filt = [
        _Template(
            lambda e: e["reprojected_err"] < 8.5312946721e-07,
            (_P1,),
            lambda t: ("reproj_lt", t),
        ),
        _Template(lambda e: True, (), lambda: ("true",)),
    ]
    return noise, filt


_NOISE_TEMPLATES, _FILTER_TEMPLATES = _make_templates()


def recognize_noise(fn):
    """Spec tuple for a recognized noise model, else None.

    Tuples: ``("const", c)`` or ``("area_pow", scale, power)``.
    """
    if isinstance(fn, ConstNoise):
        return ("const", fn.value)
    if isinstance(fn, CornerAreaPower):
        return ("area_pow", fn.scale, fn.power)
    for t in _NOISE_TEMPLATES:
        spec = t.match(fn)
        if spec is not None:
            return spec
    return None


def recognize_filter(fn):
    """Spec tuple for a recognized edge filter, else None.

    Tuples: ``("reproj_lt", tau)`` or ``("true",)``.
    """
    if isinstance(fn, ReprojErrBelow):
        return ("reproj_lt", fn.tau)
    if isinstance(fn, KeepAll):
        return ("true",)
    for t in _FILTER_TEMPLATES:
        spec = t.match(fn)
        if spec is not None:
            return spec
    return None
