"""A SIGNATURES table that matches csrc/k.cu."""

import ctypes

SOURCES = {"k": "k.cu"}

SIGNATURES = {
    "rl_add": (
        "k",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p],
    ),
}


def bind(lib):
    for fn, (_owner, argtypes) in SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
