"""A SIGNATURES table that matches csrc/k.cu entry for entry."""

import ctypes

SOURCES = {"k": "k.cu"}

_VP = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_F32 = ctypes.c_float

_TAIL = [ctypes.c_ulonglong, ctypes.POINTER(_VP)]

SIGNATURES = {
    "rl_step": ("k", [_VP, _I64, _VP, _I32, _VP]),
    "rl_decide": ("k", [_VP, _VP, _F32, _I32, _VP, _VP]),
    "rl_wide": ("k", [_VP, *_TAIL]),
}


def bind(lib):
    for fn, (_owner, argtypes) in SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
