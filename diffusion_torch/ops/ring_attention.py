"""Ring (sequence-parallel) attention over the ranks of an sp group.

Counterpart of `diffusion_tpu/ops/ring_attention.py`. Every rank holds
(B, S/n, H, D) q/k/v shards of a sequence that n ranks split in order.

- Forward: n steps. Each computes the resident queries' attention
  against the visiting K/V block, with its logsumexp (the flash kernel
  where `ops/attention.py::flash_eligible` takes the block's shape, else
  the plain version), merges it into the running (out, lse) by
  logaddexp (`_merge`), and passes the block to the next rank while the
  step computes (`batch_isend_irecv`, issued before the step's work).
- Backward, from the saved global lse: p = exp(s - lse) of each block is
  then exact, so each step runs the flash backward (dQ and dK/dV kernels)
  against the visiting block; dq accumulates at home in fp32, and the
  dK/dV accumulators travel with their blocks, which are home again after
  n rotations. delta = rowsum(dO * O) is computed once for the plain
  version (the dQ kernel writes it on every launch).

The ring is one dispatcher op (`torch.library.custom_op`) with its own
backward, so a selective-checkpoint policy keeps its (out, lse) and never
re-runs the ring, as JAX names `flash_out`/`flash_lse` for its remat.

The per-step bodies (`forward_step`, `backward_step`) are the same
functions whether the blocks come from other ranks or from a list of n
local shards (`ring_attention_shards`, `ring_attention_shards_bwd`), which
visit the blocks in the ring's order and sum in its order, so one rank can
hold the ring's kernel work against the whole-sequence kernels (the same
results as n ranks, bit for bit).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from diffusion_torch.ops.flash_attention import (flash_attention_bwd_op,
                                                 flash_attention_bwd_reference,
                                                 flash_attention_cuda,
                                                 flash_attention_reference)

__all__ = ["ring_attention", "forward_step", "backward_step",
           "ring_attention_shards", "ring_attention_shards_bwd"]


def _kernel(q: torch.Tensor, k: torch.Tensor) -> bool:
    from diffusion_torch.ops.attention import flash_eligible
    return flash_eligible(q.device.type, q.dtype, q.shape, k.shape, False)


def _merge(o, l, o_b, l_b):
    """Merge a block's partial softmax (o_b, l_b) into the running fp32
    (o, l); l and l_b are (B, H, Sq), o (B, Sq, H, D)."""
    l_new = torch.logaddexp(l, l_b)
    w_old = torch.exp(l - l_new).transpose(1, 2)[..., None]
    w_new = torch.exp(l_b - l_new).transpose(1, 2)[..., None]
    return o * w_old + o_b.float() * w_new, l_new


def forward_step(q, kb, vb, o, l):
    """One ring step: the queries against block (kb, vb), merged into the
    running (o, l)."""
    fwd = flash_attention_cuda if _kernel(q, kb) else flash_attention_reference
    o_b, l_b = fwd(q, kb, vb)
    return _merge(o, l, o_b, l_b)


def backward_step(q, kb, vb, out, lse, do, delta, dq, dkb, dvb):
    """One ring step of the backward: the block's (dq, dk, dv) under the
    global lse, added to the fp32 accumulators in place. The kernels run
    through the flash backward's dispatcher op, which a FLOP count sees."""
    if _kernel(q, kb):
        dq_b, dk_b, dv_b = flash_attention_bwd_op(q, kb, vb, out, lse, do)
    else:
        dq_b, dk_b, dv_b = flash_attention_bwd_reference(q, kb, vb, out, lse,
                                                         do, delta)
    dq += dq_b.float()
    dkb += dk_b.float()
    dvb += dv_b.float()


def _start(q):
    b, sq, h, _ = q.shape
    return (torch.zeros(q.shape, device=q.device, dtype=torch.float32),
            torch.full((b, h, sq), float("-inf"), device=q.device,
                       dtype=torch.float32))


def _delta(out, do):
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _Ring:
    """The sp group's ranks and a rotation to the next rank."""

    def __init__(self, name: str):
        from diffusion_torch.parallel.sharding import process_group
        self.group = process_group(name)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.index = dist.get_rank(self.group)
        self.n = len(self.ranks)

    def rotate(self, tensors: Sequence[torch.Tensor]):
        """Start sending `tensors` to the next rank and receiving the
        previous rank's; returns (buffers, works). A one-rank ring hands
        the tensors back (a transport may refuse to send to itself)."""
        if self.n == 1:
            return list(tensors), []
        nxt = self.ranks[(self.index + 1) % self.n]
        prv = self.ranks[(self.index - 1) % self.n]
        recv = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t, nxt, self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, r, prv, self.group) for r in recv])
        return recv, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


@torch.library.custom_op("diffusion_torch::ring_attention", mutates_args=())
def _ring_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    ring = _Ring(group)
    o, l = _start(q)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(ring.n):
        nxt = ring.rotate([kb, vb]) if i < ring.n - 1 else None
        o, l = forward_step(q, kb, vb, o, l)
        if nxt is not None:
            _wait(nxt[1])
            kb, vb = nxt[0]
    return o.to(q.dtype), l


def _ring_setup(ctx, inputs, output):
    ctx.group = inputs[3]
    ctx.save_for_backward(*inputs[:3], *output)


def _ring_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    ring = _Ring(ctx.group)
    do = do.contiguous()
    delta = None if _kernel(q, k) else _delta(out, do)
    dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    kb, vb = k.contiguous(), v.contiguous()
    dkb = torch.zeros(k.shape, device=k.device, dtype=torch.float32)
    dvb = torch.zeros_like(dkb)
    for i in range(ring.n):
        last = i == ring.n - 1
        # the blocks move on while this step computes; their accumulators
        # follow once the step has added to them
        nxt = None if last else ring.rotate([kb, vb])
        backward_step(q, kb, vb, out, lse, do, delta, dq, dkb, dvb)
        acc, works = ring.rotate([dkb, dvb])
        _wait(works)
        dkb, dvb = acc
        if nxt is not None:
            _wait(nxt[1])
            kb, vb = nxt[0]
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None


_ring_op.register_autograd(_ring_backward, setup_context=_ring_setup)
ring_attention_op = torch.ops.diffusion_torch.ring_attention.default


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   shard) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the sequence the sp group `shard`
    (`parallel/sharding.py::RowShard`) splits; q/k/v are this rank's
    (B, S/n, H, D) shards, and so is the output. Differentiable in q, k
    and v."""
    return _ring_op(q, k, v, shard.group)[0]


def ring_attention_shards(qs: List[torch.Tensor], ks: List[torch.Tensor],
                          vs: List[torch.Tensor]
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring over n local shards: shard r's (out, lse) from the blocks
    in the order rank r of a ring would see them (block r - i at step i)."""
    n = len(qs)
    outs, lses = [], []
    for r in range(n):
        o, l = _start(qs[r])
        for i in range(n):
            o, l = forward_step(qs[r], ks[(r - i) % n], vs[(r - i) % n], o, l)
        outs.append(o.to(qs[r].dtype))
        lses.append(l)
    return outs, lses


def ring_attention_shards_bwd(qs, ks, vs, outs, lses, dos,
                              deltas: Optional[List[torch.Tensor]] = None):
    """The ring backward over n local shards: (dqs, dks, dvs), each dK/dV
    block summed in the order its accumulator would visit the ranks."""
    n = len(qs)
    if deltas is None:
        deltas = [None if _kernel(qs[r], ks[r]) else _delta(outs[r], dos[r])
                  for r in range(n)]
    dqs = [torch.zeros(q.shape, device=q.device, dtype=torch.float32)
           for q in qs]
    dks = [torch.zeros(k.shape, device=k.device, dtype=torch.float32)
           for k in ks]
    dvs = [torch.zeros_like(d) for d in dks]
    # step i: rank r works on block (r - i) mod n; the steps of a block's
    # accumulator follow one another in i
    for i in range(n):
        for r in range(n):
            j = (r - i) % n
            backward_step(qs[r], ks[j], vs[j], outs[r], lses[r], dos[r],
                          deltas[r], dqs[r], dks[j], dvs[j])
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])
