"""Replica-desync checks for the data-parallel trainer (the counterpart of
``recsys_tpu/utils/debug.py``'s replica checksums).

Every data-parallel rank holds the whole params and ends each step with
the same bits: the gradients come from one all-reduce, which hands every
rank the same sum, and every update after it is the same arithmetic on
the same inputs. A bad collective, a per-rank RNG leak or a rank-local
reduction in another order breaks that silently. These helpers make it
visible:

* :func:`per_device_checksums`: each rank checksums its own copy of a
  tree, and the checksums of every rank are gathered to every rank;
* :func:`assert_replicated`: raises ``RuntimeError`` when they differ.

Under row-sharded tables the shards are meant to differ from rank to
rank: the callers name them in ``skip`` and the checks cover the other
leaves, as the JAX package's ``per_device_checksums`` covers only the
leaves whose sharding is replicated.

Two checksums per rank, as in the JAX package: an fp32 magnitude sum
(sum |x| + sum x over every leaf, for the log; one flipped low bit
vanishes in it) and the detector, an XOR fold of every fp32 leaf's bit
pattern, which any changed bit changes. ``TrainConfig.debug_nans``
(``enable_nan_checks``) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from recsys_tpu_torch.parallel.mesh import MeshContext


def _leaves(tree: Any, skip: Sequence[str] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k not in skip:
                yield from _leaves(tree[k], skip)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, skip)
    elif isinstance(tree, torch.Tensor):
        yield tree.detach()


def _tree_checksum(tree: Any, skip: Sequence[str] = ()) -> float:
    """The fp32 magnitude checksum: sum |x| + sum x over every leaf."""
    total = torch.zeros((), dtype=torch.float32)
    for leaf in _leaves(tree, skip):
        x = leaf.float()
        total = total + (torch.sum(torch.abs(x)) + torch.sum(x)).cpu()
    return float(total)


def _tree_bit_checksum(tree: Any, skip: Sequence[str] = ()) -> int:
    """The XOR fold of every leaf's bit pattern as uint32 (floats as fp32)."""
    total = np.uint32(0)
    for leaf in _leaves(tree, skip):
        if leaf.is_floating_point():
            bits = leaf.float().cpu().numpy().view(np.uint32)
        else:
            bits = leaf.cpu().numpy().astype(np.uint32)
        total ^= np.bitwise_xor.reduce(bits.ravel(), initial=np.uint32(0))
    return int(total)


def per_device_checksums(tree: Any, ctx: MeshContext, skip: Sequence[str] = ()
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (magnitude checksums [world] fp64, bit checksums [world] int64),
    one per rank of the process group, in rank order, on every rank, over
    the leaves of ``tree`` whose key is not in ``skip`` (the row-sharded
    tables). A collective: every rank calls it with its own copy of
    ``tree``."""
    mine = torch.tensor([_tree_checksum(tree, skip), float(_tree_bit_checksum(tree, skip))],
                        dtype=torch.float64, device=ctx.device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    out = torch.stack(parts).cpu().numpy()
    return out[:, 0], out[:, 1].astype(np.int64)


def assert_replicated(tree: Any, ctx: MeshContext, rtol: float = 1e-6,
                      skip: Sequence[str] = ()) -> np.ndarray:
    """Raise ``RuntimeError`` when the ranks' copies of ``tree`` (less the
    leaves named in ``skip``) are not bitwise equal (the XOR checksums
    differ), or, as a second check, when their magnitude checksums differ
    beyond ``rtol``. -> the magnitude checksums, for the log."""
    sums, bits = per_device_checksums(tree, ctx, skip)
    if np.any(bits != bits[0]):
        raise RuntimeError(
            f"replica desync detected: per-rank bit checksums "
            f"{[hex(int(b)) for b in bits]} differ: nominally replicated state is not "
            f"bitwise identical across the mesh's ranks (magnitude "
            f"checksums {sums.tolist()})")
    tol = rtol * max(abs(float(sums[0])), 1.0)
    if np.any(np.abs(sums - sums[0]) > tol):
        raise RuntimeError(
            f"replica desync detected: per-rank checksums {sums.tolist()} (tolerance "
            f"{tol:.3g}): nominally replicated state differs across the mesh's ranks")
    return sums
