"""Sequence/context parallelism: ring attention and Ulysses.

Counterpart of `paddle_tpu/parallel/sp.py`. The reference runs each
algorithm per shard inside `shard_map` over the mesh's 'sp' axis and moves
blocks with `lax.ppermute`/`all_to_all`. The port keeps its single
controller: `sequence_parallel_attention` splits the global
`[B, S, H, D]` tensors along S, one shard per device of the 'sp' axis
(at index 0 of any other axis: the reference replicates the same work
there), runs every hop of every shard in this process, and moves a block
to the next slot with `Tensor.to(device, non_blocking=True)` (nothing to
copy when two slots name one device). The `*_local` functions take and
return those per-slot lists of shards.

- Ring attention (`ring_flash_attention_local`): the hand-written kernels
  of `kernels/ring_attention.py`. The forward launches one kernel per ring
  step and device, over every slot there, and merges each hop by its lse
  in the kernel, as the reference merges them (`_ring_flash_fwd` :191);
  its backward (`_ring_flash_bwd_rule` :234) adds each hop's dq into the
  slot's f32 accumulator and each hop's dk/dv into f32 accumulators that
  rotate with their k/v blocks for n hops, in the kernels' epilogues (one
  dq and one dk/dv launch per ring step and device). On one card, 4 slots
  take 4 forward, 4 dq and 4 dk/dv launches per layer. Dispatch is the
  reference's (:288-293): the flash ring when the local shard is at least
  128 long and a multiple of min(512, shard), else the dense einsum ring
  `ring_attention_local` (:50). The port's kernels tile on their own, so
  only that rule reads the 512. It adds one condition, for what the
  port's kernels are built for: q/k/v of one dtype, fp32, bf16 or fp16,
  and a head_dim of 64, 128 or 256 (the reference's Pallas kernels take
  any); other shards take the dense ring too.
- Ulysses (`ulysses_attention_local`): regroups the shards from sequence
  to heads, runs dense attention over the whole sequence with H/n heads
  per slot, and regroups back. It runs no kernel.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import KERNEL_DTYPES, _HEAD_DIMS
from ..nn.functional.attention import scaled_dot_product_attention
from .topology import get_mesh

# the reference's flash-ring blocks (kernels/flash_attention.py:33-34),
# which only its dispatch rule reads here
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512


def _rotate(xs, devices):
    """Each slot's block moves to the next slot: slot i + 1 receives slot i's
    (the `ppermute` with perm [(i, i + 1 mod n)])."""
    n = len(xs)
    return [xs[(i - 1) % n].to(devices[i], non_blocking=True)
            for i in range(n)]


def _devices_of(shards):
    return [x.device for x in shards]


def _block_attn(q, k, v, scale, mask=None):
    """One q-block x kv-block attention piece: (m, s, o) with m the row max
    of the logits, s the sum of exp and o the weighted V. q: [B,S,H,D]."""
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    m = logits.amax(dim=-1, keepdim=True)                        # [B,H,S,1]
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bshd", p, v)
    return m, s, o


def ring_attention_local(q, k, v, causal=False):
    """Dense-block ring attention over the per-slot shards (plain PyTorch,
    as the reference's einsum ring). q/k/v: lists of [B, S_loc, H, D], shard
    i on slot i. Rotates K/V n - 1 times, accumulating with the online
    softmax. Returns the list of outputs."""
    n = len(q)
    devices = _devices_of(q)
    b, s_loc, h, d = q[0].shape
    scale = 1.0 / math.sqrt(d)
    outs = []
    m_acc, s_acc, o_acc, qpos = [], [], [], []
    for my in range(n):
        dev = devices[my]
        m_acc.append(torch.full((b, h, s_loc, 1), -math.inf, device=dev))
        s_acc.append(torch.zeros((b, h, s_loc, 1), device=dev))
        o_acc.append(torch.zeros((b, s_loc, h, d), device=dev))
        qpos.append(my * s_loc + torch.arange(s_loc, device=dev))
    k_cur, v_cur = list(k), list(v)
    for step in range(n):
        for my in range(n):
            kb = (my - step) % n  # which K/V block this slot holds
            mask = None
            if causal:
                kpos = kb * s_loc + torch.arange(s_loc, device=devices[my])
                mask = (kpos[None, :] <= qpos[my][:, None])[None, None]
            m_new, s_new, o_new = _block_attn(
                q[my].float(), k_cur[my].float(), v_cur[my].float(), scale,
                mask)
            m_tot = torch.maximum(m_acc[my], m_new)
            alpha = torch.exp(m_acc[my] - m_tot)
            beta = torch.exp(m_new - m_tot)
            s_acc[my] = s_acc[my] * alpha + s_new * beta
            o_acc[my] = o_acc[my] * alpha.transpose(1, 2) \
                + o_new * beta.transpose(1, 2)
            m_acc[my] = m_tot
        if step < n - 1:
            k_cur, v_cur = _rotate(k_cur, devices), _rotate(v_cur, devices)
    for my in range(n):
        out = o_acc[my] / torch.clamp(s_acc[my], min=1e-20).transpose(1, 2)
        outs.append(out.to(q[my].dtype))
    return outs


def ulysses_attention_local(q, k, v, causal=False):
    """Ulysses attention over the per-slot shards: [B, S/n, H, D] shards
    regrouped to [B, S, H/n, D] (the reference's tiled `all_to_all`), dense
    attention over the full sequence, regrouped back."""
    n = len(q)
    devices = _devices_of(q)
    h = q[0].shape[2]
    if h % n:
        raise ValueError(f"ulysses attention splits {h} heads over {n} "
                         "slots: the heads must divide evenly")
    hn, s_loc = h // n, q[0].shape[1]

    def seq2head(xs):
        return [torch.cat([x[:, :, j * hn:(j + 1) * hn].to(devices[j])
                           for x in xs], dim=1) for j in range(n)]

    def head2seq(xs):
        return [torch.cat([x[:, i * s_loc:(i + 1) * s_loc].to(devices[i])
                           for x in xs], dim=2) for i in range(n)]

    qh, kh, vh = seq2head(q), seq2head(k), seq2head(v)
    d = q[0].shape[-1]
    scale = 1.0 / math.sqrt(d)
    outs = []
    for qa, ka, va in zip(qh, kh, vh):
        logits = torch.einsum("bshd,bthd->bhst", qa.float(), ka.float()) \
            * scale
        if causal:
            s_full = logits.shape[-2]
            cmask = torch.ones((s_full, s_full), dtype=torch.bool,
                               device=logits.device).tril()
            logits = logits.masked_fill(~cmask, -1e9)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", p, va.float())
                    .to(q[0].dtype))
    return head2seq(outs)


# ---- ring attention with the flash block kernels ---------------------------

def _to_bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bhsd(x, b, h):
    _, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _step_groups(devices):
    """The slots of a ring step that share a device, in slot order, cut into
    launches of at most `MAX_SLOTS`: one group of all slots on one card,
    one group per slot on as many cards."""
    from ..kernels.ring_attention import MAX_SLOTS
    by_device = {}
    for i, dev in enumerate(devices):
        by_device.setdefault(dev, []).append(i)
    return [idx[j:j + MAX_SLOTS] for idx in by_device.values()
            for j in range(0, len(idx), MAX_SLOTS)]


def _ring_flash_fwd(q, k, v, causal):
    """Forward ring: one kernel launch per ring step and device covering
    every slot there, each hop merged by lse into the slot's f32
    accumulators in the kernel's epilogue (out = sum_hops exp(lse_hop -
    lse_total) * out_hop); the last step writes out in q's dtype. Returns
    the per-slot outputs [B, S_loc, H, D] and global lse rows
    [BH, 1, S_loc]."""
    from ..kernels.ring_attention import ring_fwd_step
    n = len(q)
    devices = _devices_of(q)
    b, s, h, d = q[0].shape
    qf = [_to_bhsd(x) for x in q]
    k_cur, v_cur = [_to_bhsd(x) for x in k], [_to_bhsd(x) for x in v]
    # written by the first step, read by the later ones (none with n = 1)
    o = [torch.empty((b * h, s, d), dtype=torch.float32, device=dev)
         if n > 1 else None for dev in devices]
    lse = [torch.empty((b * h, 1, s), dtype=torch.float32, device=dev)
           for dev in devices]
    out = [None] * n
    groups = _step_groups(devices)
    for step in range(n):
        for grp in groups:
            res = ring_fwd_step(
                [qf[i] for i in grp], [k_cur[i] for i in grp],
                [v_cur[i] for i in grp],
                [(i * s, ((i - step) % n) * s) for i in grp],
                [o[i] for i in grp], [lse[i] for i in grp], causal,
                first=step == 0, last=step == n - 1)
            if res is not None:
                for i, x in zip(grp, res):
                    out[i] = x
        if step < n - 1:
            k_cur, v_cur = _rotate(k_cur, devices), _rotate(v_cur, devices)
    return [_from_bhsd(x, b, h) for x in out], lse


def _ring_flash_bwd(q, k, v, out, lse, g, causal):
    """Backward ring: each hop's dq is added into the slot's f32
    accumulator in the dq kernel's epilogue; the f32 dk/dv accumulators
    rotate WITH their k/v blocks, take each hop in the dk/dv kernel's
    epilogue and arrive home after n hops (one launch of each per ring step
    and device). delta and the zeroed dq accumulator come from one prep
    pass per slot. The global lse makes every hop's p globally normalized,
    so the hops' contributions just sum."""
    from ..kernels.flash_attention import flash_bwd_prep
    from ..kernels.ring_attention import ring_dkv_step, ring_dq_step
    n = len(q)
    devices = _devices_of(q)
    b, s, h, d = q[0].shape
    qf = [_to_bhsd(x) for x in q]
    dof = [_to_bhsd(x) for x in g]
    prep = [flash_bwd_prep(gx, _to_bhsd(ox), workspace=True)
            for gx, ox in zip(dof, out)]
    delta = [x[:, None, :] for x, _ in prep]
    dq = [ws for _, ws in prep]
    k_cur, v_cur = [_to_bhsd(x) for x in k], [_to_bhsd(x) for x in v]
    # written by the first step's kernels, added to by the later ones
    dk_cur = [torch.empty((b * h, s, d), dtype=torch.float32, device=dev)
              for dev in devices]
    dv_cur = [torch.empty_like(x) for x in dk_cur]
    groups = _step_groups(devices)
    for step in range(n):
        offs = [(my * s, ((my - step) % n) * s) for my in range(n)]
        for grp in groups:
            ring_dq_step(*([x[i] for i in grp] for x in (
                qf, k_cur, v_cur, dof, lse, delta, offs, dq)), causal)
            ring_dkv_step(*([x[i] for i in grp] for x in (
                qf, k_cur, v_cur, dof, lse, delta, offs, dk_cur, dv_cur)),
                causal, first=step == 0)
        # k/v need not make the last hop: nothing reads them after it
        if step < n - 1:
            k_cur, v_cur = _rotate(k_cur, devices), _rotate(v_cur, devices)
        dk_cur, dv_cur = _rotate(dk_cur, devices), _rotate(dv_cur, devices)
    return ([_from_bhsd(x, b, h).to(q[0].dtype) for x in dq],
            [_from_bhsd(x, b, h).to(k[0].dtype) for x in dk_cur],
            [_from_bhsd(x, b, h).to(v[0].dtype) for x in dv_cur])


class _RingFlash(torch.autograd.Function):
    """The `custom_vjp` `_ring_flash` (:184-279) over the per-slot shards:
    apply(causal, *q, *k, *v) -> n outputs; saves (q, k, v, out, lse) as
    `_ring_flash_fwd_rule` does."""

    @staticmethod
    def forward(ctx, causal, *qkv):
        n = len(qkv) // 3
        q, k, v = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        out, lse = _ring_flash_fwd(q, k, v, causal)
        ctx.causal, ctx.n = causal, n
        ctx.save_for_backward(*qkv, *out, *lse)
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        n = ctx.n
        saved = ctx.saved_tensors
        q, k, v = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        out, lse = saved[3 * n:4 * n], saved[4 * n:]
        g = [gx.contiguous() for gx in grads]
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, g, ctx.causal)
        return (None, *dq, *dk, *dv)


def _kernels_take(q, k, v):
    """Whether the ring kernels take these shards: one dtype, fp32, bf16
    or fp16, and a head_dim they are built for."""
    dtype = q[0].dtype
    return (dtype in KERNEL_DTYPES and k[0].dtype == v[0].dtype == dtype
            and q[0].shape[-1] in _HEAD_DIMS)


def ring_flash_attention_local(q, k, v, causal=False, block_q=None,
                               block_k=None):
    """Ring attention with the flash block kernels over the per-slot
    shards; the dense einsum ring when the local sequence is too short for
    the reference's flash blocks (its rule, sp.py:288-293), or when the
    kernels do not take the shards' dtype or head_dim (the reference's
    Pallas kernels take any: odd head dims and float64 compute there, so
    they compute here, on the dense ring)."""
    s_loc = q[0].shape[1]
    bq = min(block_q or DEFAULT_BLOCK_Q, s_loc)
    bk = min(block_k or DEFAULT_BLOCK_K, s_loc)
    if s_loc < 128 or s_loc % bq or s_loc % bk or not _kernels_take(q, k, v):
        return ring_attention_local(q, k, v, causal=causal)
    return list(_RingFlash.apply(bool(causal), *q, *k, *v))


_LOCAL = {"ring": ring_flash_attention_local,
          "ring_dense": ring_attention_local}


def sequence_parallel_attention(q, k, v, impl="ring", causal=False, mesh=None,
                                axis_name="sp"):
    """Global entry point: q/k/v [B, S, H, D], split on S over the mesh's
    'sp' axis. Differentiable. With no mesh, or an 'sp' axis of 1, it is
    `scaled_dot_product_attention`. The output lies on q's device."""
    mesh = mesh or get_mesh()
    if mesh is None or axis_name not in mesh.shape or mesh.shape[axis_name] == 1:
        return scaled_dot_product_attention(q, k, v, is_causal=causal)
    local = _LOCAL.get(impl, ulysses_attention_local)
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(f"sequence_parallel_attention: S={q.shape[1]} does "
                         f"not split into {n} equal shards")

    def shard(x):
        return [c.to(dev, non_blocking=True)
                for c, dev in zip(x.chunk(n, dim=1), devices)]

    outs = local(shard(q), shard(k), shard(v), causal=causal)
    return torch.cat([o.to(q.device, non_blocking=True) for o in outs], dim=1)


class SequenceParallelAttention:
    """Layer-ish wrapper selecting ring vs ulysses by sequence/head geometry."""

    def __init__(self, impl="auto", causal=True, axis_name="sp"):
        self.impl = impl
        self.causal = causal
        self.axis_name = axis_name

    def __call__(self, q, k, v):
        impl = self.impl
        if impl == "auto":
            mesh = get_mesh()
            n = mesh.shape.get(self.axis_name, 1) if mesh else 1
            heads = q.shape[2]
            impl = "ulysses" if heads % max(n, 1) == 0 and heads >= n * 2 else "ring"
        return sequence_parallel_attention(q, k, v, impl=impl, causal=self.causal,
                                           axis_name=self.axis_name)


__all__ = ["SequenceParallelAttention", "ring_attention_local",
           "ring_flash_attention_local", "sequence_parallel_attention",
           "ulysses_attention_local"]
