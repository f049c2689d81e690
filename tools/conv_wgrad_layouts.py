#!/usr/bin/env python3
"""The paper CNN's four convolutions as ``torch.func.vmap`` over 10 clients
issues them (one grouped convolution, groups = clients), in each memory
layout cuDNN can be handed, timed and held against float64 on the same
inputs.

    python3 tools/conv_wgrad_layouts.py

For each convolution (batch 10 images a client, SAME padding) and each way
of running the clients' backward pass (``convolution_backward``: input and
weight gradients): grouped on NCHW tensors (what vmap's batching rule makes
of the model's tensors), grouped on channels-last tensors, client by client
on channels-last tensors (the sequential engine), and grouped with cuDNN
disabled.  Prints each one's largest error against float64 relative to the
largest entry, and its device time (CUDA events, median of 20), and the
cuDNN kernels each ran.  Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import sys

import torch

CLIENTS, BATCH = 10, 10
# name: (in channels, out channels, kernel, height = width)
CONVS = {"conv1a": (3, 32, 5, 32), "conv1b": (32, 32, 3, 32),
         "conv2a": (32, 64, 5, 16), "conv2b": (64, 64, 3, 16)}


def backward(gy, x, w, groups):
    k = w.shape[-1]
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0],
        groups, [True, True, False])[:2]


def ways(gy, x, w):
    """(label, fn) over the grouped tensors: gy (N, G*O, H, W), x (N, G*C,
    H, W), w (G*O, C, k, k)."""
    cl = torch.channels_last
    gyc, xc, wc = (t.contiguous(memory_format=cl) for t in (gy, x, w))
    G, O, C = CLIENTS, w.shape[0] // CLIENTS, x.shape[1] // CLIENTS

    def loop():
        outs = [backward(gyc[:, g * O:(g + 1) * O], xc[:, g * C:(g + 1) * C],
                         wc[g * O:(g + 1) * O], 1) for g in range(G)]
        return (torch.cat([o[0] for o in outs], 1),
                torch.cat([o[1] for o in outs], 0))

    def no_cudnn():
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            return backward(gy, x, w, G)

    return [("grouped, NCHW (as vmap issues it)", lambda: backward(gy, x, w, G)),
            ("grouped, channels-last", lambda: backward(gyc, xc, wc, G)),
            ("client by client, channels-last", loop),
            ("grouped, cuDNN disabled", no_cudnn)]


def rel(a, b):
    return ((a.double() - b).abs().max() / b.abs().max()).item()


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name.split("(")[0][:90] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_wgrad_layouts: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (C, O, k, H) in CONVS.items():
        G = CLIENTS
        x = torch.relu(torch.randn(BATCH, G * C, H, H, device=dev,
                                   generator=gen))
        w = torch.randn(G * O, C, k, k, device=dev, generator=gen) * (
            2.0 / (C * k * k)) ** 0.5
        gy = torch.randn(BATCH, G * O, H, H, device=dev, generator=gen) * 1e-3
        want = backward(gy.double(), x.double(), w.double(), G)
        print(f"== {name}: {C} -> {O}, {k}x{k}, {H}x{H}, {G} clients of "
              f"{BATCH} images")
        for label, fn in ways(gy, x, w):
            gx, gw = fn()
            print(f"  {label}: weight gradient {rel(gw, want[1]):.2e}, input "
                  f"gradient {rel(gx, want[0]):.2e}, {time_ms(fn):.4f} ms")
            print("    kernels: " + "; ".join(kernel_names(fn)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
