"""A drifted SIGNATURES table (see csrc/k.cu): a long long slot count
declared c_int32, a dropped parameter, a symbol the source does not
export, one it exports with no entry, and a library SOURCES does not
name."""

import ctypes

SOURCES = {"k": "k.cu"}

_VP = ctypes.c_void_p
_I32 = ctypes.c_int32
_U64 = ctypes.c_ulonglong
_F32 = ctypes.c_float

_TAIL = [_U64, ctypes.POINTER(_VP)]

SIGNATURES = {
    "rl_step": ("k", [_VP, _I32, _VP, _I32, _VP]),
    "rl_decide": ("k", [_VP, _VP, _F32, _I32, _VP]),
    "rl_wide": ("k", [_VP, *_TAIL]),
    "rl_missing": ("k", [_VP]),
    "rl_orphan": ("other", [_VP]),
}


def bind(lib):
    for fn, (_owner, argtypes) in SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
