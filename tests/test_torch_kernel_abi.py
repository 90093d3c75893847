"""The C interface of the port's CUDA kernels (`sp_gan_tpu_torch/csrc/*.cu`)
against the ctypes signatures `ops/kernels/_build.py` loads them with.

ctypes takes the declared types on faith: a pointer declared as an int is
cut to 32 bits, a long long argument or result read as an int is cut, and
a missing argument leaves the C function reading a register the caller
never set. No CPU test reaches the kernels themselves, so this reads each
`extern "C"` definition from the sources and holds its parameter types and
its result type to `SIGNATURES` and `RESTYPES`.
"""

import ctypes
import re

import pytest

from sp_gan_tpu_torch.ops.kernels import _build

DEF = re.compile(r'extern\s+"C"\s+(int|long long)\s+(spgan_\w+)\s*\(([^)]*)\)'
                 r"\s*\{")


def c_type(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}[kind]


def definitions() -> dict:
    """{name: (result type, [parameter types])} of every extern "C"
    function the sources define."""
    out = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for ret, name, params in DEF.findall(src.read_text()):
            assert name not in out, f"{name} is defined twice"
            out[name] = ({"int": ctypes.c_int,
                          "long long": ctypes.c_longlong}[ret],
                         [c_type(p) for p in params.split(",")])
    return out


def test_every_entry_point_has_a_signature():
    assert set(definitions()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_source(name):
    ret, params = definitions()[name]
    assert list(_build.SIGNATURES[name]) == params, name
    assert _build.RESTYPES.get(name, ctypes.c_int) is ret, name
