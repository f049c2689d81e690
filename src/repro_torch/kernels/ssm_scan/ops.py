"""The selective-SSM scan in the reference's public layout — the kernel for
a CUDA tensor, the plain version for a CPU tensor — and its gradient.

The reference's wrapper (``repro/kernels/ssm_scan/ops.py``) also takes
``chunk`` and ``block_d``, the TPU grid's block sizes, halving each until it
divides S and D, and ``interpret``.  The CUDA kernel tiles the steps and the
channels itself and masks ragged edges, so none of them carries over.

Where a gradient is asked for (grad mode on and an input requiring one),
the call goes through ``SsmScan``, an autograd function whose forward is
the same kernel and whose backward is the backward kernel
(``ssm_scan_bwd``) on the card and ``ref.ssm_scan_bwd_ref`` on the CPU.
Otherwise it launches what serving always launched.

The scan, the scan into a given state and the backward are each one
operator of their own (``repro_torch::ssm_scan``, ``ssm_scan_into``,
``ssm_scan_bwd``), so that an op recorder sees a call as one site and a
fake tensor passes through with its shape.  A ``DTensor`` call runs each
rank's shard through ``local_map``
(:func:`repro_torch.sharding.context.local_dims`): the batch over the
batch axes and the channels over ``model``; A's gradient is a partial sum
over the batch, B's and C's over the channels.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import ref as ref_lib
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_cuda
from repro_torch.kernels.ssm_scan.ssm_scan_bwd import ssm_scan_bwd_cuda
from repro_torch.sharding.context import is_dtensor, local_dims

# roles of the layouts (see local_dims): x, dt, y (B, S, D); A (D, N);
# Bc, Cc (B, S, N); h0, h (B, D, N)
SEQ, WEIGHT, PROJ, STATE = "b.m", "m.", "b..", "bm."


def _plain(x, dt, A, Bc, Cc, h0, h_out=None):
    if x.device.type == "cuda":
        return ssm_scan_cuda(x, dt, A, Bc, Cc, h0, h_out=h_out)
    if x.device.type == "cpu":
        y, h = ref_lib.ssm_scan_ref(x, dt, A, Bc, Cc, h0)
        return y, (h if h_out is None else h_out.copy_(h))
    raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          Bc: torch.Tensor, Cc: torch.Tensor, h0: Optional[torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _plain(x, dt, A, Bc, Cc, h0)


@_scan.register_fake
def _scan_fake(x, dt, A, Bc, Cc, h0):
    return (torch.empty_like(x),
            x.new_empty((x.shape[0], x.shape[2], A.shape[1])))


@torch.library.custom_op("repro_torch::ssm_scan_into", mutates_args=("h_out",))
def _scan_into(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, h0: Optional[torch.Tensor],
               h_out: torch.Tensor) -> torch.Tensor:
    """The scan with its last state written into ``h_out`` (which may be
    ``h0``); returns y."""
    return _plain(x, dt, A, Bc, Cc, h0, h_out)[0]


@_scan_into.register_fake
def _scan_into_fake(x, dt, A, Bc, Cc, h0, h_out):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def _scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor, h0: Optional[torch.Tensor],
              dy: torch.Tensor, dh: Optional[torch.Tensor]
              ) -> List[torch.Tensor]:
    """(dx, ddt, dA, dB, dC), and dh0 where h0 is given."""
    if x.device.type == "cuda":
        grads = ssm_scan_bwd_cuda(x, dt, A, Bc, Cc, h0, dy, dh)
    else:
        grads = ref_lib.ssm_scan_bwd_ref(x, dt, A, Bc, Cc, h0, dy, dh)
    return [g for g in grads if g is not None]


@_scan_bwd.register_fake
def _scan_bwd_fake(x, dt, A, Bc, Cc, h0, dy, dh):
    return [torch.empty_like(t) for t in (x, dt, A, Bc, Cc, h0)
            if t is not None]


def _forward(x, dt, A, Bc, Cc, h0, h_out=None):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
    if not is_dtensor(x):
        if h_out is None:
            return _scan(x, dt, A, Bc, Cc, h0)
        return _scan_into(x, dt, A, Bc, Cc, h0, h_out), h_out
    ins = ((x, SEQ), (dt, SEQ), (A, WEIGHT), (Bc, PROJ), (Cc, PROJ),
           (h0, STATE))
    if h_out is None:
        return local_dims(_scan, *ins, out=(SEQ, STATE))
    return local_dims(_scan_into, *ins, (h_out, STATE), out=SEQ), h_out


def _backward(x, dt, A, Bc, Cc, h0, dy, dh):
    if not is_dtensor(x):
        grads = _scan_bwd(x, dt, A, Bc, Cc, h0, dy, dh)
    else:
        outs = (SEQ, SEQ, WEIGHT + "+b", PROJ + "+m", PROJ + "+m")
        grads = local_dims(
            lambda *a: tuple(_scan_bwd(*a)), (x, SEQ), (dt, SEQ),
            (A, WEIGHT), (Bc, PROJ), (Cc, PROJ), (h0, STATE), (dy, SEQ),
            (dh, STATE), out=outs + (() if h0 is None else (STATE,)))
    return tuple(grads) + ((None,) if h0 is None else ())


class SsmScan(torch.autograd.Function):
    """The scan, with the backward kernel as its gradient on the card.
    Inputs are contiguous float32; h0 may be None."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, h0):
        y, h = _forward(x, dt, A, Bc, Cc, h0)
        ctx.save_for_backward(x, dt, A, Bc, Cc, h0)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bc, Cc, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.float().contiguous()
        if dh is not None:
            dh = dh.float().contiguous()
        return _backward(x, dt, A, Bc, Cc, h0, dy, dh)


def ssm_scan(x, dt, A, Bc, Cc, h0: Optional[torch.Tensor] = None, *,
             h_out: Optional[torch.Tensor] = None):
    """x/dt: (B, S, D); A: (D, N); Bc/Cc: (B, S, N); h0: (B, D, N) or None
    -> (y (B, S, D) float32, h (B, D, N) float32).  Every input is cast to
    float32, as the reference's wrapper casts it.  ``h_out``, a contiguous
    (B, D, N) float32 tensor, receives h (and is returned as h); it may be
    ``h0`` itself, which decode uses to update the cached state in place.
    Differentiable without ``h_out``; asking for a gradient with it
    raises."""
    x, dt, A, Bc, Cc = (t.to(torch.float32).contiguous()
                        for t in (x, dt, A, Bc, Cc))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    inputs = (x, dt, A, Bc, Cc) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if h_out is not None:
            raise NotImplementedError("ssm_scan writes h_out in place, which "
                                      "no gradient flows through")
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
        return SsmScan.apply(x, dt, A, Bc, Cc, h0)
    return _forward(x, dt, A, Bc, Cc, h0, h_out)
