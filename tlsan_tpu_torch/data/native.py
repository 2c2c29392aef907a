"""ctypes bindings for the native (C++) dataset builders.

Ported from tlsan_tpu/data/native.py, taking numpy columns (data/remap.py)
where the JAX package's take DataFrames.  Each ``build_*_packed`` is a
fused replacement for a builder of data/builders.py plus its packer of
data/batcher.py, with output equal byte for byte (tests/test_torch_data.py).
The shared library is compiled on demand with g++ (plain C ABI, no
pybind11) from the repository's shared sources ``native/builder.cpp`` and
``native/pyrandom.h`` into this package's ``_build/``, named by a hash of
the sources and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Mapping, Optional, Tuple

import numpy as np

from tlsan_tpu_torch.data.batcher import Batches, round8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
_CFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> str:
    """Where the library of the current sources and flags lives (mtimes
    are not kept by git, so the name hashes the contents)."""
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    for name in ("pyrandom.h", "builder.cpp"):
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtlsan_native-{h.hexdigest()[:12]}.so")


def _build_library() -> str:
    lib_path = library_path()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = lib_path + f".tmp{os.getpid()}"
        subprocess.run(["g++", *_CFLAGS, "-o", tmp,
                        os.path.join(_SRC_DIR, "builder.cpp")],
                       check=True, capture_output=True)
        os.replace(tmp, lib_path)  # atomic vs concurrent builders
    return lib_path


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build_library())
    lib.tlsan_build.restype = ctypes.c_void_p
    lib.tlsan_build.argtypes = [
        _i32p, _i32p, _i64p, ctypes.c_int64, _i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
    lib.tlsan_counts.restype = None
    lib.tlsan_counts.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p]
    lib.tlsan_pack_train.restype = None
    lib.tlsan_pack_train.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _f32p, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p]
    lib.tlsan_pack_test.restype = None
    lib.tlsan_pack_test.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _i32p, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p]
    lib.tlsan_free.restype = None
    lib.tlsan_free.argtypes = [ctypes.c_void_p]
    lib.prefix_build.restype = ctypes.c_void_p
    lib.prefix_build.argtypes = [
        _i32p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64]
    lib.prefix_counts.restype = None
    lib.prefix_counts.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p]
    lib.prefix_pack_train.restype = None
    lib.prefix_pack_train.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p, _f32p, _i32p, _f32p, _i32p]
    lib.prefix_pack_test.restype = None
    lib.prefix_pack_test.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _i32p, _i32p, _f32p, _i32p]
    lib.prefix_free.restype = None
    lib.prefix_free.argtypes = [ctypes.c_void_p]
    lib.tlsan_max_pre.restype = None
    lib.tlsan_max_pre.argtypes = [ctypes.c_void_p, _i64p]
    lib.session_pack_basic_train.restype = None
    lib.session_pack_basic_train.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _f32p, _i32p, _i32p, _i32p, _i32p]
    lib.session_pack_basic_test.restype = None
    lib.session_pack_basic_test.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p]
    lib.bpr_build.restype = None
    lib.bpr_build.argtypes = [
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        _i64p, _i64p, _i32p, _i32p]
    _lib = lib
    return lib


def _columns(reviews: Mapping[str, np.ndarray]):
    """The (user, item, day) columns as contiguous int32/int32/int64."""
    return (np.ascontiguousarray(reviews["reviewerID"], np.int32),
            np.ascontiguousarray(reviews["asin"], np.int32),
            np.ascontiguousarray(reviews["unixReviewTime"], np.int64))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_tlsan_packed(reviews, cate_list: np.ndarray, item_count: int,
                       Ls: int = 10, max_length: int = 90, seed: int = 1234,
                       Ts: Optional[int] = None,
                       ) -> Tuple[Batches, Batches, int]:
    """Fused native build+pack.  Returns (train, test, Ts)."""
    lib = _load()
    uids, asins, times = _columns(reviews)
    cate_list = np.ascontiguousarray(cate_list, np.int32)

    h = lib.tlsan_build(
        _ptr(uids, ctypes.c_int32), _ptr(asins, ctypes.c_int32),
        _ptr(times, ctypes.c_int64), len(uids),
        _ptr(cate_list, ctypes.c_int32), item_count,
        int(cate_list.max()) + 1, max_length, seed)
    try:
        tn = ctypes.c_int64()
        sn = ctypes.c_int64()
        ts = ctypes.c_int64()
        lib.tlsan_counts(h, ctypes.byref(tn), ctypes.byref(sn), ctypes.byref(ts))
        train_n, test_n = tn.value, sn.value
        if Ts is None:
            Ts = round8(ts.value)

        def alloc(n):
            return dict(
                u=np.empty(n, np.int32), i=np.empty(n, np.int32),
                c=np.empty(n, np.int32),
                hist_i=np.empty((n, Ls), np.int32),
                hist_t=np.empty((n, Ls), np.float32),
                hist_i_new=np.empty((n, Ts), np.int32),
                sl=np.empty(n, np.int32), sl_new=np.empty(n, np.int32))

        tr = alloc(train_n)
        tr["y"] = np.empty(train_n, np.float32)
        lib.tlsan_pack_train(
            h, Ls, Ts,
            _ptr(tr["u"], ctypes.c_int32), _ptr(tr["i"], ctypes.c_int32),
            _ptr(tr["y"], ctypes.c_float), _ptr(tr["c"], ctypes.c_int32),
            _ptr(tr["hist_i"], ctypes.c_int32), _ptr(tr["hist_t"], ctypes.c_float),
            _ptr(tr["hist_i_new"], ctypes.c_int32),
            _ptr(tr["sl"], ctypes.c_int32), _ptr(tr["sl_new"], ctypes.c_int32))

        te = alloc(test_n)
        te["j"] = np.empty(test_n, np.int32)
        lib.tlsan_pack_test(
            h, Ls, Ts,
            _ptr(te["u"], ctypes.c_int32), _ptr(te["i"], ctypes.c_int32),
            _ptr(te["j"], ctypes.c_int32), _ptr(te["c"], ctypes.c_int32),
            _ptr(te["hist_i"], ctypes.c_int32), _ptr(te["hist_t"], ctypes.c_float),
            _ptr(te["hist_i_new"], ctypes.c_int32),
            _ptr(te["sl"], ctypes.c_int32), _ptr(te["sl_new"], ctypes.c_int32))
    finally:
        lib.tlsan_free(h)

    return Batches(tr, train_n), Batches(te, test_n), Ts


_TIME_MODES = {"none": 0, "bucket": 1, "raw": 2}


def build_prefix_packed(reviews, item_count: int, time_mode: str = "none",
                        max_length: int = 90, pack_pos_neg: bool = False,
                        align: str = "left", T: Optional[int] = None,
                        seed: int = 1234) -> Tuple[Batches, Batches, int]:
    """Fused native build+pack for the prefix scheme
    (ATRank/CNN/CSAN/Bi-LSTM/LSPM).  Bit-exact vs
    builders.build_prefix_examples + batcher.pack_prefix_train/_test
    (tests/test_torch_data.py).  Returns (train, test, T)."""
    lib = _load()
    uids, asins, times = _columns(reviews)
    tm = _TIME_MODES[time_mode]

    h = lib.prefix_build(
        _ptr(uids, ctypes.c_int32), _ptr(asins, ctypes.c_int32),
        _ptr(times, ctypes.c_int64), len(uids), item_count, max_length,
        1 if pack_pos_neg else 0, seed)
    try:
        tn, sn, mh = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        lib.prefix_counts(h, ctypes.byref(tn), ctypes.byref(sn), ctypes.byref(mh))
        train_n, test_n = tn.value, sn.value
        if T is None:
            T = round8(mh.value)
        ar = 1 if align == "right" else 0
        with_time = tm != 0
        null_f32 = ctypes.cast(None, _f32p)
        null_i32 = ctypes.cast(None, _i32p)

        def alloc(n):
            d = dict(u=np.empty(n, np.int32), i=np.empty(n, np.int32),
                     hist_i=np.empty((n, T), np.int32),
                     sl=np.empty(n, np.int32))
            if with_time:
                d["hist_t"] = np.empty((n, T), np.float32)
            return d

        tr = alloc(train_n)
        if pack_pos_neg:
            tr["j"] = np.empty(train_n, np.int32)
        else:
            tr["y"] = np.empty(train_n, np.float32)
        lib.prefix_pack_train(
            h, T, ar, tm, 1 if pack_pos_neg else 0,
            _ptr(tr["u"], ctypes.c_int32), _ptr(tr["i"], ctypes.c_int32),
            _ptr(tr["j"], ctypes.c_int32) if pack_pos_neg else null_i32,
            null_f32 if pack_pos_neg else _ptr(tr["y"], ctypes.c_float),
            _ptr(tr["hist_i"], ctypes.c_int32),
            _ptr(tr["hist_t"], ctypes.c_float) if with_time else null_f32,
            _ptr(tr["sl"], ctypes.c_int32))

        te = alloc(test_n)
        te["j"] = np.empty(test_n, np.int32)
        lib.prefix_pack_test(
            h, T, ar, tm,
            _ptr(te["u"], ctypes.c_int32), _ptr(te["i"], ctypes.c_int32),
            _ptr(te["j"], ctypes.c_int32),
            _ptr(te["hist_i"], ctypes.c_int32),
            _ptr(te["hist_t"], ctypes.c_float) if with_time else null_f32,
            _ptr(te["sl"], ctypes.c_int32))
    finally:
        lib.prefix_free(h)

    if time_mode == "bucket":  # int buckets 0..12 (ATRank/CNN one-hot input)
        tr["hist_t"] = tr["hist_t"].astype(np.int32)
        te["hist_t"] = te["hist_t"].astype(np.int32)
    return Batches(tr, train_n), Batches(te, test_n), T


def build_session_basic_packed(reviews, cate_list: np.ndarray,
                               item_count: int, variant: str,
                               max_length: int = 90, seed: int = 1234,
                               Ls: Optional[int] = None,
                               Ls_cap: Optional[int] = None,
                               Ts: Optional[int] = None,
                               ) -> Tuple[Batches, Batches, int, int]:
    """Fused native build+pack for SHAN/PACA (session scheme, no time
    features; PACA drops uid).  Bit-exact vs build_session_examples +
    pack_session_train/_test.  Returns (train, test, Ls, Ts)."""
    assert variant in ("shan", "paca")
    lib = _load()
    uids, asins, times = _columns(reviews)
    cate_list = np.ascontiguousarray(cate_list, np.int32)

    h = lib.tlsan_build(
        _ptr(uids, ctypes.c_int32), _ptr(asins, ctypes.c_int32),
        _ptr(times, ctypes.c_int64), len(uids),
        _ptr(cate_list, ctypes.c_int32), item_count,
        int(cate_list.max()) + 1, max_length, seed)
    try:
        tn, sn, ts = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        lib.tlsan_counts(h, ctypes.byref(tn), ctypes.byref(sn), ctypes.byref(ts))
        train_n, test_n = tn.value, sn.value
        if Ts is None:
            # PACA carries no short session — the Python path pins Ts to
            # round8(1) = 8 (train/cli.py sess_max=1); match it so cfg.Ts
            # is identical between native and Python builds
            Ts = 8 if variant == "paca" else round8(ts.value)
        if Ls is None:
            mp = ctypes.c_int64()
            lib.tlsan_max_pre(h, ctypes.byref(mp))
            Ls = round8(mp.value)
            if Ls_cap is not None:
                Ls = min(Ls, Ls_cap)
        has_uid = variant == "shan"
        null_i32 = ctypes.cast(None, _i32p)

        def alloc(n):
            d = dict(i=np.empty(n, np.int32),
                     hist_i=np.empty((n, Ls), np.int32),
                     sl=np.empty(n, np.int32))
            if has_uid:
                d["u"] = np.empty(n, np.int32)
                d["hist_i_new"] = np.empty((n, Ts), np.int32)
                d["sl_new"] = np.empty(n, np.int32)
            return d

        tr = alloc(train_n)
        tr["y"] = np.empty(train_n, np.float32)
        lib.session_pack_basic_train(
            h, Ls, Ts,
            _ptr(tr["u"], ctypes.c_int32) if has_uid else null_i32,
            _ptr(tr["i"], ctypes.c_int32), _ptr(tr["y"], ctypes.c_float),
            _ptr(tr["hist_i"], ctypes.c_int32),
            _ptr(tr["hist_i_new"], ctypes.c_int32) if has_uid else null_i32,
            _ptr(tr["sl"], ctypes.c_int32),
            _ptr(tr["sl_new"], ctypes.c_int32) if has_uid else null_i32)

        te = alloc(test_n)
        te["j"] = np.empty(test_n, np.int32)
        lib.session_pack_basic_test(
            h, Ls, Ts,
            _ptr(te["u"], ctypes.c_int32) if has_uid else null_i32,
            _ptr(te["i"], ctypes.c_int32), _ptr(te["j"], ctypes.c_int32),
            _ptr(te["hist_i"], ctypes.c_int32),
            _ptr(te["hist_i_new"], ctypes.c_int32) if has_uid else null_i32,
            _ptr(te["sl"], ctypes.c_int32),
            _ptr(te["sl_new"], ctypes.c_int32) if has_uid else null_i32)
    finally:
        lib.tlsan_free(h)

    return Batches(tr, train_n), Batches(te, test_n), Ls, Ts


def build_bpr_packed(reviews, item_count: int, seed: int = 1234
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Native BPR triples (uid, pos, neg): train [N,3], test [U,3] int32 —
    bit-exact vs builders.build_pairwise_examples."""
    lib = _load()
    uids, asins, _ = _columns(reviews)
    n = len(uids)
    train = np.empty((n, 3), np.int32)
    test = np.empty((n, 3), np.int32)
    tn, sn = ctypes.c_int64(), ctypes.c_int64()
    lib.bpr_build(_ptr(uids, ctypes.c_int32), _ptr(asins, ctypes.c_int32),
                  n, item_count, seed, ctypes.byref(tn), ctypes.byref(sn),
                  _ptr(train, ctypes.c_int32), _ptr(test, ctypes.c_int32))
    return train[:tn.value].copy(), test[:sn.value].copy()
