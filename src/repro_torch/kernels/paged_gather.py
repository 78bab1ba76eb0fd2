"""K8: the paged K/V gather of the block-paged decode cache, and its
scatter back.

The paged engine keeps each layer's K/V in a block pool
``[n_blocks, block_size, Hkv, hd]`` addressed through a per-row block
table ``pages [B, max_blocks]`` (int32 block ids, ``-1`` = unallocated).
The attention layer gathers the pool into the logical
``[B, max_blocks * block_size, Hkv, hd]`` view, writes its new rows into
that view, attends over it, and scatters the view back.

  - :func:`paged_gather` replaces ``repro/kernels/paged_gather.py:90
    paged_gather`` (the scalar-prefetch kernel of ``_make_gather``, :55):
    unallocated blocks read as zeros (kernel: ``csrc/paged_gather.cu``).
    A pure copy, so it is bitwise :func:`paged_gather_plain`.
  - :func:`paged_scatter` ports ``paged_scatter`` (:104), which is plain
    jnp in the reference too: a torch ``index_copy_`` into the pool that
    drops the slices of unallocated blocks.

CUDA tensors launch the kernel or raise; CPU tensors run the plain
version. Neither function reads the table back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(pool, pages) -> None:
    if pool.ndim != 4 or pages.ndim != 2:
        raise ValueError(f"paged gather takes pool [n_blocks, bs, Hkv, hd] "
                         f"and pages [B, max_blocks], got "
                         f"{tuple(pool.shape)} and {tuple(pages.shape)}")


def paged_gather_plain(pool, pages):
    """Plain PyTorch version of the kernel's function (the reference's
    ``paged_gather_ref``). An id outside ``[0, n_blocks)`` reads as zeros,
    as in the kernel; the reference would clamp an id past the pool, which
    the engine never issues."""
    n_blocks, bs, hkv, hd = pool.shape
    b, mb = pages.shape
    valid = (pages >= 0) & (pages < n_blocks)
    ids = torch.where(valid, pages, 0).long()
    blocks = pool[ids]                              # [B, mb, bs, Hkv, hd]
    blocks = torch.where(valid[..., None, None, None], blocks,
                         torch.zeros((), dtype=pool.dtype,
                                     device=pool.device))
    return blocks.reshape(b, mb * bs, hkv, hd)


# The kernel's C entry point, bound at the first launch (the build runs
# then, never at import).
_gather_entry = None


def paged_gather(pool, pages):
    """pool [n_blocks, bs, Hkv, hd] (any dtype), pages int32
    [B, max_blocks] → [B, max_blocks * bs, Hkv, hd]. The kernel's output
    never carries a graph, so only the plain route needs grad mode off."""
    global _gather_entry
    _check(pool, pages)
    if pool.device.type == "cpu":
        with torch.no_grad():
            return paged_gather_plain(pool, pages)
    _build.check_operands("paged_gather", pool, pages)
    if pages.dtype != torch.int32:
        raise TypeError(f"paged_gather: pages has dtype {pages.dtype}, "
                        f"expected torch.int32")
    n_blocks, bs, hkv, hd = pool.shape
    b, mb = pages.shape
    out = pool.new_empty((b, mb * bs, hkv, hd))
    if out.numel() == 0:
        return out
    if _gather_entry is None:
        _gather_entry = _build.library().paged_gather
    rc = _gather_entry(pool.data_ptr(), pages.data_ptr(), out.data_ptr(),
                       n_blocks, b * mb, bs * hkv * hd * pool.element_size(),
                       _build.stream_of(pool))
    _build.check(rc, "paged_gather")
    paged_gather.launches += 1
    return out


paged_gather.launches = 0


@_build.no_grad
def paged_scatter(pool, pages, values):
    """Write the logical view ``values [B, max_blocks * bs, Hkv, hd]`` back
    into ``pool`` IN PLACE through ``pages`` and return it; the slices of
    unallocated (-1) blocks are dropped, as the reference's
    ``.at[].set(mode="drop")`` drops them.

    The drop happens on the device: every dropped slice is redirected to
    the first valid entry's block with that entry's own values (or, when
    the table holds no valid entry, to block 0 with block 0's content), so
    each block id receives one value however often it is written, and the
    table is never read back to the host."""
    _check(pool, pages)
    n_blocks, bs, hkv, hd = pool.shape
    b, mb = pages.shape
    if b * mb == 0:
        return pool
    vals = values.reshape(b * mb, bs, hkv, hd).to(pool.dtype)
    ids = pages.reshape(-1).long()
    valid = (ids >= 0) & (ids < n_blocks)
    first = valid.int().argmax()                    # 0 when none is valid
    has = valid.any()
    sink_id = torch.where(has, ids[first], 0)
    sink_val = torch.where(has, vals[first], pool[0])
    ids = torch.where(valid, ids, sink_id)
    vals = torch.where(valid[:, None, None, None], vals, sink_val)
    return pool.index_copy_(0, ids, vals)
