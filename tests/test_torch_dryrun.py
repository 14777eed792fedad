"""The port's dry run (``repro_torch.launch.dryrun``,
``repro_torch.utils.step_analysis``) against the reference's
(``repro.launch.dryrun``): the cells each package runs, the per-rank
argument bytes against XLA's ``memory_analysis()``, fake runs against
real ones, the memory tracker, and flash's fake ops.  Everything runs
on the CPU (device "cpu"): no test fakes "cuda" and differentiates."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import warnings

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import (ALL_ARCHS, SHAPES, ShapeConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.configs.base import cell_supported
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (HBM_BYTES, NIC_BW, NVLINK_BW,
                                     axis_links, make_production_mesh)
from repro_torch.sharding.specs import MeshShape
from repro_torch.sharding.tensor_parallel import Collective
from repro_torch.utils import step_analysis as sa

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF_ARCHS = ("llama3-8b", "granite-moe-3b-a800m", "hymba-1.5b")
REF_SHAPES = ("prefill_32k", "decode_32k", "train_4k")
MESH_2x2 = MeshShape((2, 2), ("data", "model"))
MESH_1x4 = MeshShape((1, 4), ("data", "model"))

# the reference's own run_cell on a (2, 2) mesh of 4 host devices, its
# configs reduced; its production mesh is rebuilt with Auto axes (jax
# 0.9's default Explicit axes refuse its sharding constraints)
REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from jax.sharding import AxisType
    jax.devices()
    import repro.configs as rc
    import repro.launch.mesh as m
    m.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    full = rc.get_config
    rc.get_config = lambda a: rc.reduce_for_smoke(full(a))
    from repro.launch.dryrun import run_cell
    out = {f"{a}|{s}": run_cell(a, s, False)["memory"]
           for a in sys.argv[1].split(",") for s in sys.argv[2].split(",")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_memory():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          ",".join(REF_ARCHS), ",".join(REF_SHAPES)],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# (a) the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_supported_agrees(arch):
    from repro.configs import SHAPES as REF_SHAPES_ALL
    from repro.configs import get_config as ref_config
    from repro.configs.base import cell_supported as ref_supported

    assert sorted(SHAPES) == sorted(REF_SHAPES_ALL)
    for name in SHAPES:
        mine = cell_supported(get_config(arch), SHAPES[name])
        assert mine == ref_supported(ref_config(arch), REF_SHAPES_ALL[name])
        if not mine[0]:
            rec = dryrun.run_cell(arch, name, False, device="cpu")
            assert rec == {"arch": arch, "shape": name, "mesh": "16x16",
                           "status": "skipped", "reason": mine[1]}


def test_cell_counts():
    ok = [cell_supported(get_config(a), SHAPES[s])[0]
          for a in ALL_ARCHS for s in SHAPES]
    assert (len(ok), sum(ok)) == (40, 32)


# ---------------------------------------------------------------------------
# (b) per-rank argument bytes against the reference's memory_analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCHS)
@pytest.mark.parametrize("shape", REF_SHAPES)
def test_argument_bytes_equal_reference(ref_memory, arch, shape):
    parts = dryrun._arguments(reduce_for_smoke(get_config(arch)),
                              SHAPES[shape], MESH_2x2, device="cpu")
    want = ref_memory[f"{arch}|{shape}"]["argument_size_in_bytes"]
    assert sum(parts.values()) == want, (parts, want)


@pytest.mark.parametrize("shape", ("decode_32k", "train_4k"))
def test_run_step_counts_its_arguments(shape):
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    rec = dryrun.run_step(cfg, SHAPES[shape], MESH_2x2, device="cpu")
    assert rec["parts"] == dryrun._arguments(cfg, SHAPES[shape], MESH_2x2,
                                             device="cpu")
    mem = rec["memory"]
    # each storage rounded up to the allocator's 512-byte blocks
    assert 0 <= mem["argument_size_in_bytes"] - sum(rec["parts"].values()) \
        < 512 * 64
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"]


# ---------------------------------------------------------------------------
# (c) a fake run against a real one
# ---------------------------------------------------------------------------

FAKE_REAL = [(a, k) for a in ("llama3-8b", "granite-moe-3b-a800m",
                              "hymba-1.5b", "llama-3.2-vision-90b",
                              "xlstm-125m")
             for k in ("prefill", "decode", "train")] + [
    ("hubert-xlarge", "prefill"), ("hubert-xlarge", "train")]


@pytest.mark.parametrize("arch,kind", FAKE_REAL)
def test_fake_run_equals_real_run(arch, kind):
    cfg = reduce_for_smoke(get_config(arch))
    shape = ShapeConfig("t", 32 if kind == "train" else 64,
                        8 if kind == "train" else 4, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fake = dryrun.run_step(cfg, shape, MESH_1x4, device="cpu")
        real = dryrun.run_step(cfg, shape, MESH_1x4, device="cpu",
                               fake=False)
    assert fake["cost"]["flops"] == real["cost"]["flops"] > 0
    assert fake["collectives"] == real["collectives"]
    assert fake["collectives"]["total_bytes"] > 0
    assert fake["memory"] == real["memory"]
    assert fake["parts"] == real["parts"] and fake["caches"] == real["caches"]


# ---------------------------------------------------------------------------
# (d) the memory tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fake", (False, True))
def test_step_memory_known_peak(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode() if fake else None
    with mode if mode is not None else torch.no_grad():
        x = torch.empty(256)                      # 1,024 bytes
        mem = sa.StepMemory()
        mem.arguments({"x": x, "view": x[3:]})
        with mem:
            a = torch.empty(1000)                 # 4,000 -> 4,096
            b = torch.empty(100)                  # 400 -> 512
            del a                                 # live 1,024 + 512
            c = torch.empty(2000)                 # 8,000 -> 8,192
            v = c[10:]                            # a view: no block
            del b                                 # live 1,024 + 8,192
            d = c + 1                             # 8,192: peak 17,408
            del c
            x.add_(1)                             # in place: no block
        mem.outputs((v, d, x))
    assert mem.memory() == {"argument_size_in_bytes": 1024,
                            "output_size_in_bytes": 16384,
                            "temp_size_in_bytes": 16384,
                            "peak_bytes": 17408}
    del v, d
    assert mem.live == 1024


# ---------------------------------------------------------------------------
# (e) flash's fake ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset", ((True, 0, 0),
                                                    (True, 8, 4),
                                                    (False, 0, 0)))
def test_flash_fake_ops(monkeypatch, causal, window, q_offset):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)

    def refuse(*a, **k):
        raise AssertionError("a fake call built the library")
    monkeypatch.setattr(_build, "load", refuse)
    B, S, T, H, KV, hd = 2, 24, 40, 4, 2, 16
    n0 = (ops.launches, ops.bwd_launches)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with FakeTensorMode():
        q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(B, T, KV, hd, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fwd:
            o = ops.flash_attention_op(q, k, k, **kw)
        o2, lse, _ = ops._forward(q, k, k, causal, window, q_offset,
                                  with_lse=True)
        with FlopCounterMode(display=False) as bwd:
            dq, dk, dv = ops.flash_attention_bwd_op(q, k, k, o2, o2, lse,
                                                    **kw)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "cuda")
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert (ops.launches, ops.bwd_launches) == n0
    # the formulas count what the plain versions compute
    g = torch.Generator().manual_seed(0)
    qr, kr, vr, dor = (torch.randn(*s, generator=g) for s in
                       ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd),
                        (B, H, S, hd)))
    with FlopCounterMode(display=False) as plain:
        orr = attention_ref(qr, kr, vr, **kw)
    assert fwd.get_total_flops() == plain.get_total_flops() \
        == 4 * B * H * S * T * hd
    lr = attention_lse_ref(qr, kr, **kw)
    with FlopCounterMode(display=False) as plain_bwd:
        attention_bwd_ref(qr, kr, vr, orr, dor, lr, **kw)
    assert bwd.get_total_flops() == plain_bwd.get_total_flops() \
        == 10 * B * H * S * T * hd


def test_flash_cpu_tensor_takes_the_plain_version(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    monkeypatch.setattr(_build, "load", lambda *a, **k: 1 / 0)
    q = torch.randn(1, 8, 2, 16)
    out = ops.flash_attention_op(q, q, q)
    assert torch.equal(out, ops._plain(q, q, q, True, 0, 0))


# ---------------------------------------------------------------------------
# (f) a production cell at full width, and the accounting's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_cell(multi_pod):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = dryrun.run_cell("llama3-8b", "decode_32k", multi_pod,
                              device="cpu")
    assert rec["status"] == "ok"
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["fits"] and 0 < rec["memory"]["peak_bytes"] <= HBM_BYTES
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["by_op_bytes"].values()) \
        == sum(coll["by_axis_bytes"].values()) > 0
    assert rec["roofline"]["dominant"] in ("t_comp", "t_mem", "t_coll")
    assert rec["params"] == get_config("llama3-8b").n_params()
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700 W"


@pytest.mark.parametrize("arch,kind", (("llama3-8b", "train"),
                                       ("granite-moe-3b-a800m", "prefill")))
def test_pod_and_data_group(arch, kind):
    """A step on three axes gathers or reduces over a flattened ("pod",
    "data") group: its bytes are booked to "pod+data", on the NICs."""
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = dryrun.run_step(reduce_for_smoke(get_config(arch)),
                              ShapeConfig("t", 32, 8, kind), mesh,
                              device="cpu")
    by_axis = rec["collectives"]["by_axis_bytes"]
    assert by_axis.get("pod+data", 0) > 0, by_axis
    assert set(by_axis) <= {"pod", "data", "model", "pod+data"}
    links = axis_links(mesh, ("pod+data",))
    assert links["pod+data"]["link"] == "nvlink"     # ranks 0, 2, 4, 6
    assert rec["roofline"]["t_coll"] == pytest.approx(
        sum(b / links[a]["bytes_per_s"] for a, b in by_axis.items()))


@pytest.mark.parametrize("arch,shape", (("hubert-xlarge", "decode_32k"),
                                        ("llama3-8b", "long_500k")))
def test_main_resumes(tmp_path, capsys, arch, shape):
    out = tmp_path / "cells.jsonl"
    args = ["--arch", arch, "--out", str(out), "--device", "cpu",
            "--shape", shape]
    dryrun.main(args)
    dryrun.main(args)
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        (arch, shape, "skipped")]
    assert f"[skip-done] {arch} x {shape}" in capsys.readouterr().out


def test_step_collectives_reads_functional_groups():
    """The dry run's log books a functional collective to its group (its
    last string argument), not to its reduce op's name, and c10d's to
    theirs."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fake_mesh

    fc = torch.ops._c10d_functional
    mesh = make_fake_mesh(MESH_1x4, "cpu")
    try:
        group = mesh.get_group("model")
        name, x = group.group_name, torch.ones(8)
        with sa.StepCollectives() as log:
            for y in (fc.all_reduce(x, "sum", name),
                      fc.reduce_scatter_tensor(x, "sum", 4, name),
                      fc.all_gather_into_tensor(x, 4, name)):
                fc.wait_tensor(y)
            dist.all_reduce(x, group=group)
    finally:
        dist.destroy_process_group()
    ops = {c.op.split(".")[1]: c.group for c in log.calls
           if sa.collective_kind(c.op) is not None}
    assert ops == dict.fromkeys(("all_reduce", "reduce_scatter_tensor",
                                 "all_gather_into_tensor", "allreduce_"),
                                name)


def test_collective_bytes_by_kind_and_axis():
    calls = [Collective("c10d._allgather_base_.default", "g1", [[8], [2]],
                        [32, 8]),
             Collective("_c10d_functional.all_reduce.default", "g2", [[4]],
                        [16]),
             Collective("_c10d_functional.wait_tensor.default", None, [[4]],
                        [16]),
             Collective("c10d._reduce_scatter_base_.default", "g1",
                        [[2], [8]], [8, 32]),
             Collective("c10d.alltoall_base_.default", "g2", [[4], [4]],
                        [16, 16]),
             Collective("_c10d_functional.all_gather_into_tensor.default",
                        "g2", [[2]], [8]),
             Collective("_c10d_functional.reduce_scatter_tensor.default",
                        "g1", [[8]], [32])]
    rec = sa.collective_bytes(calls, {"g1": "data", "g2": "model"},
                              {"g1": 4, "g2": 2})
    assert rec["by_op_bytes"] == {"all-gather": 48, "all-reduce": 16,
                                  "reduce-scatter": 16, "all-to-all": 16,
                                  "collective-permute": 0}
    assert rec["by_op_count"]["all-gather"] == 2 and rec["total_bytes"] == 96
    assert rec["by_axis_bytes"] == {"data": 48, "model": 48}


def test_roofline_links():
    assert {k: v["link"] for k, v in axis_links(
        make_production_mesh(multi_pod=True)).items()} == {
        "pod": "nic", "data": "nic", "model": "nic"}
    assert {k: v["link"] for k, v in axis_links(
        MeshShape((4, 2), ("data", "model"))).items()} == {
        "data": "nvlink", "model": "nvlink"}
    links = axis_links(MeshShape((2, 8), ("data", "model")))
    assert (links["model"]["link"], links["data"]["link"]) == ("nvlink", "nic")
    r = sa.roofline_terms(989e12, 3.35e12, 0, 16,
                          by_axis={"model": NVLINK_BW, "data": NIC_BW},
                          links=links)
    assert r["t_comp"] == pytest.approx(1.0) and r["t_mem"] == \
        pytest.approx(1.0) and r["t_coll"] == pytest.approx(2.0)
    assert r["dominant"] == "t_coll" and r["bound_s"] == pytest.approx(2.0)
    assert r["links"] == {"model": "nvlink", "data": "nic"}
    assert sa.roofline_terms(0, 0, NIC_BW, 16)["links"] == {"all": "nic"}
    assert sa.model_flops(10, 3, "train") == 180.0
