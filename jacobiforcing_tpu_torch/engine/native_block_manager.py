"""ctypes binding of the native C++ block manager (csrc/block_manager.cpp).

Port of `jacobiforcing_tpu/engine/native_block_manager.py`: the same
interface as `engine/block_manager.BlockManager` (the one the scheduler and
the engine call), backed by the port's own copy of the C++ allocator.  The
library is built with the host compiler at first use into `build/host/`
(`ops/_build.build_host`); nothing is built under `native/`.  Unlike the JAX
loader, which falls back to the Python allocator without a word, a build or
load failure raises: the engine takes the Python allocator only when
`JF_NATIVE_BM=0` asks for it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from jacobiforcing_tpu_torch.engine.sequence import Sequence
from jacobiforcing_tpu_torch.ops import _build


def load_native_lib() -> ctypes.CDLL:
    """The loaded library with its C signatures declared, built if needed.
    Raises RuntimeError, naming JF_NATIVE_BM=0, if it cannot be built or
    loaded."""
    try:
        lib = _build.load_host("block_manager")
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the native block manager could not be built or loaded (set "
                           f"JF_NATIVE_BM=0 for the Python one): {e}") from e
    i32p = ctypes.POINTER(ctypes.c_int32)
    for name, res, args in (
        ("jf_bm_create", ctypes.c_void_p, [ctypes.c_int, ctypes.c_int]),
        ("jf_bm_destroy", None, [ctypes.c_void_p]),
        ("jf_bm_num_free", ctypes.c_int, [ctypes.c_void_p]),
        ("jf_bm_allocate_prompt", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int]),
        ("jf_bm_ensure_capacity", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]),
        ("jf_bm_deallocate", None, [ctypes.c_void_p, ctypes.c_int64]),
        ("jf_bm_get_table", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, i32p, ctypes.c_int]),
        ("jf_bm_prefix_hits", ctypes.c_long, [ctypes.c_void_p]),
        ("jf_bm_prefix_queries", ctypes.c_long, [ctypes.c_void_p]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


class NativeBlockManager:
    """Same interface as engine.block_manager.BlockManager, C++-backed."""

    def __init__(self, num_pages: int, page_size: int):
        self._lib = load_native_lib()
        self._bm = self._lib.jf_bm_create(num_pages, page_size)
        self.page_size = page_size
        self.num_pages = num_pages

    def __del__(self):
        bm = getattr(self, "_bm", None)
        if bm:
            self._lib.jf_bm_destroy(bm)
            self._bm = None

    # ---- stats ----
    @property
    def num_free_pages(self) -> int:
        return self._lib.jf_bm_num_free(self._bm)

    @property
    def prefix_cache_hits(self) -> int:
        return self._lib.jf_bm_prefix_hits(self._bm)

    @property
    def prefix_cache_queries(self) -> int:
        return self._lib.jf_bm_prefix_queries(self._bm)

    # ---- interface ----
    def can_allocate(self, seq: Sequence, margin_tokens: int = 0) -> bool:
        need = (len(seq) + margin_tokens + self.page_size - 1) // self.page_size
        return need <= self.num_free_pages

    def _sync_table(self, seq: Sequence) -> None:
        n = len(seq.block_table) + 64
        while True:
            buf = (ctypes.c_int32 * n)()
            got = self._lib.jf_bm_get_table(self._bm, seq.seq_id, buf, n)
            if got <= n:
                seq.block_table = list(buf[:got])
                return
            n = got

    def allocate_prompt(self, seq: Sequence, margin_tokens: int = 0) -> int:
        toks = np.asarray(seq.token_ids, np.int32)
        cached = self._lib.jf_bm_allocate_prompt(
            self._bm, seq.seq_id, toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(toks), margin_tokens)
        if cached < 0:
            raise RuntimeError("out of KV pages")
        self._sync_table(seq)
        seq.num_cached_tokens = cached
        return cached

    def ensure_capacity(self, seq: Sequence, upto_tokens: int) -> bool:
        ok = bool(self._lib.jf_bm_ensure_capacity(self._bm, seq.seq_id, upto_tokens))
        # sync even on failure: the pages appended before it stay (the Python
        # BlockManager's semantics)
        self._sync_table(seq)
        return ok

    def deallocate(self, seq: Sequence) -> None:
        self._lib.jf_bm_deallocate(self._bm, seq.seq_id)
        seq.block_table = []
        seq.num_cached_tokens = 0

    def capacity_tokens(self, seq: Sequence) -> int:
        return len(seq.block_table) * self.page_size
