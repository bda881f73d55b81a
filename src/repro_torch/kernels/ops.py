"""Public kernel API of the port, dispatched on the tensor's device only.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``), which is
what the CPU tests compare with the JAX package, and which autograd
differentiates directly.  A CUDA tensor launches the hand-written kernel
through its ``torch.autograd.Function`` (``kernels/autograd.py``), whose
backward is a kernel too (serving-only kernels are called directly), or
the call raises: there is no mode switch and no fallback from a failed
build or launch to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_chunk as _mamba
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import prefill_attention as _pf
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rwkv_chunk as _rwkv
from repro_torch.kernels import swiglu as _sw


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _forward_only(what: str, *tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is a forward-only kernel (the TPU kernel has no VJP "
            f"either, and nothing trains through it): an input that requires "
            f"grad raises")


def rmsnorm(x, w, *, eps: float = 1e-5, curry_rounds: int = 0):
    """On the card ``curry_rounds`` nonzero launches the kernel's Curry-ALU
    form (Newton rsqrt), forward only."""
    if _on_cpu(x):
        return ref.rmsnorm(x, w, eps, curry_rounds)
    if curry_rounds:
        _forward_only("rmsnorm with curry_rounds", x, w)
        return _rn.rmsnorm(x.contiguous(), w.contiguous(), eps, curry_rounds)
    return _ag.RMSNorm.apply(x, w, eps)


def apply_rope(x, positions, *, theta: float = 10_000.0):
    if _on_cpu(x):
        return ref.apply_rope(x, positions, theta)
    return _ag.Rope.apply(x, positions, theta)


def apply_rope_qk(q, k, positions, *, theta: float = 10_000.0):
    """q [B, S, H, D] and k [B, S, KvH, D] rotated at the same positions:
    on the CPU two calls of the plain version, on the card one launch (and
    one for the gradients)."""
    if _on_cpu(q):
        return ref.apply_rope(q, positions, theta), ref.apply_rope(k, positions, theta)
    return _ag.RopeQK.apply(q, k, positions, theta)


def silu_mul(gate, up, *, curry_rounds: int = 0):
    """On the card ``curry_rounds`` nonzero launches the kernel's Curry-ALU
    form (Taylor exp in the sigmoid), forward only."""
    if _on_cpu(up):
        return ref.silu_mul(gate, up, curry_rounds)
    if curry_rounds:
        _forward_only("silu_mul with curry_rounds", gate, up)
        return _sw.silu_mul(gate.contiguous(), up.contiguous(), curry_rounds)
    return _ag.SiluMul.apply(gate.contiguous(), up.contiguous())


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    lengths=None, q_offset: int = 0):
    """Full-sequence attention: q [B, Sq, H, D]; k, v [B, Sk, KvH, D];
    lengths [B] int32 bounds each sequence's keys.  On the card: without
    ``lengths`` the differentiable kernel pair (training); with it the
    forward kernel alone (the dense-slab prefill, never differentiated: an
    input that requires grad raises).  ``q_offset`` has no caller on the
    card and raises there."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   lengths=lengths, q_offset=q_offset)
    if q_offset:
        raise NotImplementedError(
            "flash_attention with q_offset has no kernel: no path on the card "
            "passes one (the dense-slab prefill attends from position 0)")
    if lengths is not None:
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise NotImplementedError(
                "flash_attention with lengths is the dense-slab serving "
                "prefill, forward only: its kernel has no backward")
        return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       lengths=lengths)[0]
    return _ag.FlashAttention.apply(q, k, v, causal, window)


def decode_attention(q, k, v, *, lengths=None):
    """One query row per sequence against a dense KV slab: q [B, H, D];
    k, v [B, Sk, KvH, D]; lengths [B] int32 (None: all Sk) -> [B, H, D]."""
    if _on_cpu(q):
        return ref.decode_attention(q, k, v, lengths=lengths)
    return _da.decode_attention(q, k, v, lengths)


def decode_attention_partial(q, k, v, *, lengths=None, kv_offset: int = 0):
    """(acc f32 [B, H, D], m [B, H], l [B, H]) over a slab whose row 0 is at
    global position ``kv_offset``."""
    if _on_cpu(q):
        return ref.decode_attention_partial(q, k, v, lengths=lengths,
                                            kv_offset=kv_offset)
    return _da.decode_attention_partial(q, k, v, lengths, kv_offset)


def paged_decode_attention(q, k_pages, v_pages, block_tables, *, lengths,
                           k_scales=None, v_scales=None):
    """``k_scales`` / ``v_scales`` [KvH, NB] f32 mark an int8 pool: on the
    card the kernel's int8-page variant dequantizes inside the kernel."""
    if _on_cpu(q):
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          lengths=lengths, k_scales=k_scales,
                                          v_scales=v_scales)
    return _da.paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                      k_scales, v_scales)


def paged_decode_attention_partial(q, k_pages, v_pages, block_tables, *,
                                   lengths, kv_offset: int = 0,
                                   skip_null: bool = False, k_scales=None,
                                   v_scales=None):
    """(acc f32 [B, H, D], m [B, H], l [B, H]) for the softmax combine.  The
    pages may be a shard's view of a pool; ``skip_null`` masks the keys of
    zero table entries (a shard-local table's foreign pages), ``kv_offset``
    shifts key positions.  On the CPU a row with no valid key comes out as
    the plain version's ``(sum of v, -1e30, count)``, on the card as the
    kernel's ``(0, -1e30, 0)``: both weigh nothing in a combine beside a
    row that sees a key."""
    if _on_cpu(q):
        return ref.paged_decode_attention_partial(
            q, k_pages, v_pages, block_tables, lengths=lengths,
            kv_offset=kv_offset, skip_null=skip_null, k_scales=k_scales,
            v_scales=v_scales)
    return _da.paged_decode_attention_partial(
        q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
        kv_offset, skip_null)


def paged_prefill_attention_partial(q, k_pages, v_pages, block_table, *,
                                    q_offset: int, length: int,
                                    skip_null: bool = False, k_scales=None,
                                    v_scales=None):
    """(acc f32 [1, C, H, D], m [1, C, H], l [1, C, H]) of one prefill
    chunk for the softmax combine, as :func:`paged_decode_attention_partial`
    (``skip_null`` over a shard's view and its local table)."""
    if _on_cpu(q):
        return ref.paged_prefill_attention_partial(
            q, k_pages, v_pages, block_table, q_offset=q_offset,
            length=length, skip_null=skip_null, k_scales=k_scales,
            v_scales=v_scales)
    return _pf.paged_prefill_attention_partial(
        q, k_pages, v_pages, block_table, q_offset=q_offset, length=length,
        skip_null=skip_null, k_scales=k_scales, v_scales=v_scales)


def paged_prefill_attention(q, k_pages, v_pages, block_table, *, q_offset: int,
                            length: int, window=None, k_scales=None,
                            v_scales=None):
    """Prefill-chunk attention over paged KV (chunk K/V already scattered);
    ``window`` keeps only the keys ``kpos > qpos - window``.  On the CPU the
    pages in ``block_table`` (a prefix-bucketed slice) are gathered,
    dequantized with ``k_scales`` / ``v_scales`` for an int8 pool, and run
    through the plain flash attention, as the JAX package's non-kernel path
    does (which is also where it sends a windowed call on the TPU).  On the
    card every call, windowed or not, launches the paged prefill kernel."""
    if _on_cpu(q):
        k_lin = ref.gather_pages(k_pages, block_table, k_scales)[None]
        v_lin = ref.gather_pages(v_pages, block_table, v_scales)[None]
        lens = torch.tensor([q_offset + length], dtype=torch.int64)
        return ref.flash_attention(q, k_lin, v_lin, causal=True,
                                   q_offset=q_offset, lengths=lens,
                                   window=window)
    return _pf.paged_prefill_attention(q, k_pages, v_pages, block_table,
                                       q_offset=q_offset, length=length,
                                       window=window, k_scales=k_scales,
                                       v_scales=v_scales)


RWKV_REF_CHUNK = 16     # the JAX package's ``ops.rwkv6_scan(ref_chunk=16)``


def rwkv6_scan(r, k, v, w, u, *, s0=None):
    """wkv recurrence: r, k, v [B, S, H, D]; w [B, S, H, D] f32; u [H, D]
    f32; s0 [B, H, D, D] f32 or None (zeros) -> (o [B, S, H, D], S_final
    [B, H, D, D] f32).  On the CPU the plain versions, chosen as the JAX
    package chooses off the TPU: the chunked form (chunks of 16) once S >=
    32, else the exact recurrence.  On the card a zero initial state
    (training) goes through the differentiable kernel pair; a carried state
    ``s0`` (recurrent serving, where the JAX package runs its plain chunked
    scan) launches the forward kernel from S0, forward only: no path of the
    JAX package differentiates through a carried state, and an input that
    requires grad raises."""
    if _on_cpu(r):
        if r.shape[1] >= 2 * RWKV_REF_CHUNK:
            return ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                          chunk=RWKV_REF_CHUNK)
        return ref.rwkv6_scan(r, k, v, w, u, s0=s0)
    if s0 is not None:
        if any(t.requires_grad for t in (r, k, v, w, u, s0)):
            raise NotImplementedError(
                "rwkv6_scan with an initial state s0 is the recurrent serving "
                "forward, forward only: its kernel has no backward (nothing "
                "trains through a carried state)")
        return _rwkv.rwkv6_fwd(r.contiguous(), k.contiguous(), v.contiguous(),
                               w.contiguous(), u.contiguous(), s0=s0)[:2]
    return _ag.RWKV6.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                           w.contiguous(), u.contiguous())


MAMBA_CHUNK = 64        # the JAX package's ``ops.mamba2_scan(chunk=64)``


def mamba2_scan(x, dt, A, B, C, *, h0=None):
    """Mamba2 SSD scan: x [B, S, H, P]; dt [B, S, H] f32; A [H] f32; B, C
    [B, S, N]; h0 [B, H, P, N] f32 or None (zeros) -> (y [B, S, H, P],
    h_final [B, H, P, N] f32).  On the CPU the plain chunked version with
    chunks of 64, as the JAX package runs off the TPU.  On the card a zero
    initial state (training) goes through the differentiable kernel pair; a
    carried state ``h0`` (recurrent serving, where the JAX package runs its
    plain chunked scan) launches the forward kernel from h0, forward only:
    no path of the JAX package differentiates through a carried state, and
    an input that requires grad raises."""
    if _on_cpu(x):
        return ref.mamba2_scan(x, dt, A, B, C, h0=h0, chunk=MAMBA_CHUNK)
    if h0 is not None:
        if any(t.requires_grad for t in (x, dt, A, B, C, h0)):
            raise NotImplementedError(
                "mamba2_scan with an initial state h0 is the recurrent serving "
                "forward, forward only: its kernel has no backward (nothing "
                "trains through a carried state)")
        return _mamba.mamba2_fwd(x.contiguous(), dt.contiguous(), A.contiguous(),
                                 B.contiguous(), C.contiguous(),
                                 h0=h0.contiguous())[:2]
    return _ag.Mamba2.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                            B.contiguous(), C.contiguous())


def mamba2_step(xt, dtt, A, Bt, Ct, h):
    """One-token Mamba2 update (decode): xt [B, H, P]; dtt [B, H] f32; Bt,
    Ct [B, N]; h [B, H, P, N] f32 -> (y [B, H, P] in xt's dtype, h_new f32).
    Plain PyTorch on every device: the JAX package has no kernel for it
    either."""
    return ref.mamba2_step(xt, dtt, A, Bt, Ct, h)


def rwkv6_step(rt, kt, vt, wt, u, S):
    """One-token wkv update (decode): rt, kt, vt, wt [B, H, D]; S [B, H, D,
    D] f32 -> (o [B, H, D] in rt's dtype, S_new f32).  Plain PyTorch on
    every device: the JAX package has no kernel for it either."""
    return ref.rwkv6_step(rt, kt, vt, wt, u, S)


def silu(x):
    """x * sigmoid(x): plain PyTorch on every device (the JAX package has no
    kernel for it either)."""
    return ref.silu(x)


# the reference's routing rule (repro ``ops.matmul`` at its defaults): a
# [K, min(PANEL_BN, N)] weight panel of at most VMEM_BUDGET bytes
PANEL_BN = 256
VMEM_BUDGET = 4 * 1024 * 1024


def weight_panel_fits(x_ndim: int, k: int, n: int, itemsize: int) -> bool:
    """The reference's routing rule for ``matmul`` (``src/repro/kernels/
    ops.py:225-228``): a 2-D input whose weight panel takes at most
    ``VMEM_BUDGET`` bytes goes to the weight-stationary kernel."""
    return x_ndim == 2 and k * min(PANEL_BN, n) * itemsize <= VMEM_BUDGET


def matmul(x, w, *, out_dtype=None):
    """x [..., K] @ w [K, N] with f32 accumulation, one rounding to
    ``out_dtype`` (default x's dtype).  On the card the call routes by the
    reference's rule, decided from shapes before any launch: a fitting
    panel (:func:`weight_panel_fits`) launches the weight-stationary kernel
    (forward only) on x and w cast to their common dtype (bf16 to f32 is
    exact, so a mixed pair gives what the plain version gives); any other
    call is ``torch.matmul`` in f32 (``ref.matmul``), the counterpart of
    the reference's XLA dot."""
    if _on_cpu(x):
        return ref.matmul(x, w, out_dtype)
    k, n = w.shape
    if weight_panel_fits(x.dim(), k, n, w.element_size()):
        _forward_only("matmul on the weight-stationary kernel", x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        return _mm.weight_stationary_matmul(
            x.to(dt).contiguous(), w.to(dt).contiguous(), out_dtype or x.dtype)
    return ref.matmul(x, w, out_dtype)
