"""All-to-all (Ulysses) sequence parallelism over the world's ranks (≅
``tpu_mpi_tests/comm/alltoall.py``).

One all-to-all (``torch.distributed.all_to_all_single`` over the world
group; the gloo group for host tensors) reshards (L_local, H, Dh)
activations from sequence-split to head-split, each rank runs attention
over the full sequence for its H/w heads, and a second all-to-all
reshards back — the split and concat axes of JAX's ``tiled=True``
``lax.all_to_all``. At world=1 both reshards are the identity (the
head-divisibility check is kept). The local attention is torch ops (the
full or the blockwise form, the JAX XLA tiers) or, with ``flash=True``,
one launch of the hand CUDA kernel over every head
(``kernels.hand.flash_attention``), reading the (L, H, Dh) layout through
its strides.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.mesh import check_world
from tpu_mpi_tests_torch.comm.ring import online_softmax_update
from tpu_mpi_tests_torch.comm.topology import mesh_link_meta
from tpu_mpi_tests_torch.instrument.telemetry import span_call
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import check_divisible


def _all_to_all(chunks: torch.Tensor) -> torch.Tensor:
    """Send ``chunks[j]`` (a (w, ...) tensor) to rank j and return the
    (w, ...) tensor whose row i came from rank i. The payload moves as
    bytes, so every dtype crosses gloo and NCCL alike."""
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    group = tdist.group.WORLD if chunks.is_cuda else dist.cpu_group()
    tdist.all_to_all_single(out.view(-1).view(torch.uint8),
                            chunks.view(-1).view(torch.uint8), group=group)
    return out


def seq_to_heads(x: torch.Tensor, world: int = 1) -> torch.Tensor:
    """Reshard (L_local, H, Dh) sequence-split → (L_global, H_local, Dh)
    head-split (≅ ``lax.all_to_all(split_axis=1, concat_axis=0,
    tiled=True)``): head block j goes to rank j; the rows of rank i land
    at ``i·L_local``. H must divide over the ranks."""
    w = check_world(world)
    hl = check_divisible(x.shape[1], w, "ulysses heads over mesh axis")
    if w == 1:
        return x
    L, _, dh = x.shape
    got = _all_to_all(x.reshape(L, w, hl, dh).transpose(0, 1))
    return got.reshape(w * L, hl, dh)


def heads_to_seq(x: torch.Tensor, world: int = 1) -> torch.Tensor:
    """Inverse of :func:`seq_to_heads` (≅ ``lax.all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``): rows ``[j·L_local, (j+1)·L_local)`` go
    to rank j; the heads of rank i land at ``i·H_local``."""
    w = check_world(world)
    if w == 1:
        return x
    lg, hl, dh = x.shape
    L = check_divisible(lg, w, "ulysses sequence over mesh axis")
    got = _all_to_all(x.reshape(w, L, hl, dh))
    return got.transpose(0, 1).reshape(L, w * hl, dh)


def _local_attention_full(q, k, v, causal: bool, precision: str):
    """Full attention over (L, H, Dh), heads batched: materialises the
    (H, L, L) scores; used when L <= block_keys."""
    d = q.shape[-1]
    with hand.matmul_precision(precision):
        s = torch.einsum("qhd,khd->hqk", q, k) / (d**0.5)
        if causal:
            L = s.shape[-1]
            mask = torch.ones((L, L), dtype=torch.bool,
                              device=q.device).tril()
            s = torch.where(mask[None, :, :], s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("hqk,khd->qhd", p, v)


def _local_attention(q, k, v, causal: bool, precision: str,
                     block_keys: int = 512):
    """Blockwise attention over (L, H, Dh): keys and values in
    ``block_keys``-wide tiles under the online softmax, the ragged tail's
    padded keys masked, so the scores take O(L·block_keys·H)."""
    L, H, d = q.shape
    if L <= block_keys:
        return _local_attention_full(q, k, v, causal, precision)
    scale = 1.0 / (d**0.5)
    nb = -(-L // block_keys)
    pad = nb * block_keys - L
    kb = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) \
        .reshape(nb, block_keys, H, d)
    vb = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) \
        .reshape(nb, block_keys, H, d)
    q_pos = torch.arange(L, device=q.device)
    m = torch.full((H, L), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((H, L), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    with hand.matmul_precision(precision):
        for b in range(nb):
            s = torch.einsum("qhd,khd->hqk", q, kb[b]) * scale
            k_pos = b * block_keys + torch.arange(block_keys,
                                                  device=q.device)
            valid = k_pos[None, :] < L  # mask padded tail keys
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            s = torch.where(valid[None, :, :], s, float("-inf"))
            m, l, p, corr = online_softmax_update(m, l, s)  # (H, L)
            acc = acc * corr.transpose(0, 1)[:, :, None] + torch.einsum(
                "hqk,khd->qhd", p, vb[b])
    return acc / l.transpose(0, 1)[:, :, None]


def _local_attention_flash(q, k, v, causal: bool, precision: str,
                           k_tile=None, skip_tile=None):
    """Flash local attention over (L, H, Dh): one hand-kernel launch over
    every head, no per-head copy (≅ the JAX ``vmap`` of
    ``flash_attention_pallas`` over axis 1)."""
    return hand.flash_attention(q, k, v, causal=causal, precision=precision,
                                k_tile=k_tile, skip_tile=skip_tile)


def ulysses_attention(q, k, v, causal: bool = False,
                      precision: str = "highest", block_keys: int = 512,
                      flash: bool = False, k_tile=None, skip_tile=None,
                      world: int = 1):
    """Per-rank Ulysses attention (≅ ``alltoall.py:120``): inputs
    (L_local, H, Dh), this rank's block of the sequence, H divisible by
    the ranks; returns this rank's (L_local, H, Dh) block of the output. The local
    attention is blockwise (``block_keys``-wide key tiles) or, with
    ``flash=True``, the hand kernel (``k_tile``/``skip_tile`` reach its
    plain version only)."""
    qh, kh, vh = (seq_to_heads(t, world) for t in (q, k, v))
    if flash:
        out = _local_attention_flash(qh, kh, vh, causal, precision,
                                     k_tile=k_tile, skip_tile=skip_tile)
    else:
        out = _local_attention(qh, kh, vh, causal, precision,
                               block_keys=block_keys)
    return heads_to_seq(out, world)


def ulysses_attention_fn(world: int = 1, causal: bool = False,
                         block_keys: int = 512, flash: bool = False,
                         k_tile=None, skip_tile=None,
                         precision: str = "highest"):
    """Ulysses attention over (L_local, H, Dh) blocks of a sequence split
    over the ranks (≅ ``alltoall.py:159``): checks the world when built,
    then returns ``attn(q, k, v)``, whose call is a ``ulysses_attention``
    telemetry span (the JAX payload: two all-to-alls, q, k, v seq→head
    and the q-shaped output head→seq, each moving (w−1)/w of the global
    operand)."""
    check_world(world)
    link = mesh_link_meta()  # the group's stamp, resolved once

    def attn(q, k, v):
        return ulysses_attention(q, k, v, causal=causal,
                                 precision=precision, block_keys=block_keys,
                                 flash=flash, k_tile=k_tile,
                                 skip_tile=skip_tile, world=world)

    def attn_recorded(q, k, v):
        moved = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        return span_call("ulysses_attention", attn, q, k, v,
                         nbytes=(world - 1) * moved, axis_name="shard",
                         world=world, flash=flash, causal=causal, **link)

    return attn_recorded
