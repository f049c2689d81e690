"""The port's cost model (``launch/graph_analysis.analyze``) and roofline
(``launch/analysis.py``) held against the reference's
``repro.launch.hlo_analysis`` and ``repro.launch.analysis``, on the CPU.

Collectives run over a fake process group (torch's ``FakeStore``): one
process stands for every rank, no data moves, and the recorder sees each
collective with its group.
"""
import math

import pytest
import torch
import torch.distributed as dist

from repro.launch import analysis as ref_analysis
from repro.launch import hlo_analysis as ref_hlo

from repro_torch.analysis.walker import record_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import graph_analysis as ga

from test_hlo_analysis import HLO


@pytest.fixture
def world():
    """A fake world of 4 ranks (this process is rank 0), gone after the
    test."""
    dryrun.fake_world(4)
    yield
    dryrun.close_world()


# ------------------------------------------------------------ roofline --
@pytest.mark.parametrize("flops,hbm,coll,chips", [
    (1e15, 1e12, 1e10, 1), (2e12, 8e11, 4e11, 256), (0.0, 5e9, 0.0, 4),
    (3e13, 0.0, 9e10, 512)])
def test_roofline_is_the_reference_formula_on_the_h100(monkeypatch, flops,
                                                       hbm, coll, chips):
    monkeypatch.setattr(ref_analysis, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(ref_analysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ref_analysis, "ICI_BW", analysis.LINK_BW)
    assert analysis.roofline(flops, hbm, coll, chips) == \
        ref_analysis.roofline(flops, hbm, coll, chips)


@pytest.mark.parametrize("mode", ["train", "fwd"])
def test_model_flops_is_the_reference_formula(mode):
    assert analysis.model_flops(1_176_832_000, 256 * 4096, mode) == \
        ref_analysis.model_flops(1_176_832_000, 256 * 4096, mode)


def test_h100_constants():
    """The card's data-sheet rates (chip_smoke.py's bounds use the same),
    not the reference's TPU v5e numbers."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW,
            analysis.HBM_PER_CHIP) == (989e12, 3.35e12, 450e9, 80e9)
    assert analysis.PEAK_FLOPS != ref_analysis.PEAK_FLOPS


# ---------------------------------------------------------- cost model --
def test_reference_program_gives_the_reference_figures(world):
    """test_hlo_analysis.py's HLO: five (8, 16) @ (16, 16) products, each
    all-reduced over a group of 4; the port's program does the same, and
    both cost models give the same figures."""
    from torch.distributed._functional_collectives import all_reduce
    group = dist.new_group(list(range(4)))

    def program(x, w):
        for _ in range(5):
            x = all_reduce(x @ w, "sum", group)
        return x

    rec, _ = record_ops(program, torch.randn(8, 16), torch.randn(16, 16),
                        detail=True)
    got = ga.analyze(rec, 4)
    want = ref_hlo.analyze(HLO, total_devices=4)
    assert got.dot_flops == want.dot_flops == 2 * 8 * 16 * 16 * 5
    assert got.collective_link_bytes == pytest.approx(
        want.collective_link_bytes) == 2 * (3 / 4) * 512 * 5
    assert got.collectives_by_kind == pytest.approx(want.collectives_by_kind)
    assert (got.n_dots, got.n_collectives) == (5, 5)
    assert got.top_collectives[0]["group"] == 4
    assert got.top_collectives[0]["mult"] == 5


def test_cross_pod_bytes_count_groups_that_span_pods(world):
    """A group within a pod adds nothing to cross_pod_link_bytes; one over
    ranks of two pods adds its link bytes (pods of 2 ranks here)."""
    from torch.distributed._functional_collectives import all_reduce
    inside, across = dist.new_group([0, 1]), dist.new_group([0, 2])
    rec, _ = record_ops(lambda x: (all_reduce(x, "sum", inside),
                                   all_reduce(x, "sum", across)),
                        torch.zeros(64), detail=True)
    cost = ga.analyze(rec, 4, pod_size=2)
    one = 2 * (1 / 2) * 256
    assert cost.collective_link_bytes == 2 * one
    assert cost.cross_pod_link_bytes == one


def test_kernel_site_counts_the_kernels_formula():
    """A flash_attention call is one site with the kernel's work (4 B H hd
    FLOPs per kept pair, each operand read once), not the plain version's
    materialised steps; its backward and the scan likewise."""
    B, S, H, KV, hd = 2, 48, 4, 2, 32
    q = torch.randn(B, S, H, hd)
    k, v = torch.randn(B, S, KV, hd), torch.randn(B, S, KV, hd)
    rec, _ = record_ops(lambda: fa_ops.flash_attention(q, k, v, causal=True),
                        detail=True)
    assert [c.op for c in rec.calls] == ["repro_torch.flash_attention"]
    cost = ga.analyze(rec, 1)
    pairs = S * (S + 1) // 2
    assert cost.dot_flops == 4 * B * H * hd * pairs
    assert cost.hbm_bytes == (2 * B * S * H * hd + 2 * B * S * KV * hd) * 4
    assert cost.n_dots == 1
    assert cost.kernels["flash_attention"]["calls"] == 1

    # the plain version's own steps, recorded, are many products
    from repro_torch.kernels.flash_attention import ref as fa_ref
    plain, _ = record_ops(lambda: fa_ref.flash_attention_ref(
        q, k, v, causal=True), detail=True)
    assert ga.analyze(plain, 1).n_dots > 1

    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    rec, _ = record_ops(lambda: fa_ops.flash_attention(
        qg, kg, vg, causal=True).sum().backward(), detail=True)
    cost = ga.analyze(rec, 1)
    assert cost.kernels["flash_attention_bwd"]["flops"] == \
        10 * B * H * hd * pairs
    assert cost.dot_flops == 14 * B * H * hd * pairs

    D, N = 16, 4
    x, dt = torch.randn(B, S, D), torch.rand(B, S, D)
    A = -torch.rand(D, N)
    Bc, Cc = torch.randn(B, S, N), torch.randn(B, S, N)
    rec, _ = record_ops(lambda: ssm_ops.ssm_scan(x, dt, A, Bc, Cc),
                        detail=True)
    cost = ga.analyze(rec, 1)
    assert cost.kernels["ssm_scan"] == {
        "calls": 1, "flops": 7 * B * S * D * N,
        "bytes": 4 * (3 * B * S * D + 2 * B * S * N + D * N + B * D * N)}
    assert cost.dot_flops == 0


def test_attention_pairs_match_the_masks():
    """The kept pairs of the causal, windowed and kv_len masks, against the
    masks built out."""
    for Sq, Sk, causal, window, q_offset, kv_len in [
            (7, 7, True, None, 0, None), (5, 9, True, 3, 4, None),
            (1, 40, False, None, 0, 17), (6, 6, False, 2, 0, None),
            (1, 30, True, 8, 29, None)]:
        q = q_offset + torch.arange(Sq)[:, None]
        kk = torch.arange(Sk)[None, :]
        keep = (kk < (Sk if kv_len is None else kv_len)).expand(Sq, Sk)
        if causal:
            keep = keep & (kk <= q)
        if window is not None:
            keep = keep & (kk > q - window)
        assert ga.attention_pairs(Sq, Sk, causal, window, q_offset,
                                  kv_len) == (int(keep.sum()),
                                              int(keep.any(0).sum()))


def test_dtensor_matmul_counts_local_flops(world):
    """A DTensor product is counted at each rank's shard: a (8, 64) @
    (64, 32) with the contraction sharded 4 ways is 2*8*32*16 FLOPs per
    rank, not the global 2*8*32*64."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    mesh = dryrun.make_mesh((4,), ("model",))
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(8, 16), mesh, [Shard(1)],
                               run_check=False)
        b = DTensor.from_local(torch.empty(16, 32), mesh, [Shard(0)],
                               run_check=False)
        rec, out = record_ops(lambda: a @ b, detail=True)
    cost = ga.analyze(rec, 4)
    assert cost.dot_flops == 2 * 8 * 32 * 16
    assert tuple(out.shape) == (8, 32)
    assert [c.inputs[0][0] for c in rec.calls if c.op == "aten.mm"] == \
        [(8, 16)]


def test_cpu_fake_group_all_to_all_counts_as_all_to_all(world):
    """On a CPU mesh DTensor stands an all-gather and a chunk in for the
    all-to-all of a Shard(1) -> Shard(0) redistribution; the recorder
    counts the all-to-all the program asked for, at its input's bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    mesh = dryrun.make_mesh((4,), ("model",))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 8), mesh, [Shard(1)],
                               run_check=False)
        rec, y = record_ops(lambda: x.redistribute(mesh, [Shard(0)]),
                            detail=True)
    cost = ga.analyze(rec, 4)
    assert tuple(y.to_local().shape) == (2, 32)
    assert cost.collectives_by_kind == {"all-to-all": 8 * 8 * 4 * 3 / 4}
    assert not any("all_gather" in c.op for c in rec.calls)


def test_host_reads_are_counted():
    rec, _ = record_ops(lambda x: [x.sum().item() for _ in range(3)],
                        torch.zeros(3), detail=True)
    cost = ga.analyze(rec, 1)
    assert cost.n_host_transfers == 3
    assert math.isclose(cost.host_transfers["aten._local_scalar_dense"], 3)
