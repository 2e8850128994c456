"""The port's roofline over its dry run (``repro_torch.launch.roofline``):
the closed forms against the JAX package's ``benchmarks/roofline.py`` and
``tests/test_roofline.py``'s properties, a record priced at the H100's
spec-sheet rates, and the dry run's count of wire bytes whose group
spans a host of 8 cards.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.roofline import analytic_terms  # noqa: E402


@pytest.mark.parametrize("mesh", ["single", "multi", (1, 1)],
                         ids=["16x16", "2x16x16", "1x1"])
def test_analytic_terms_all_cells(mesh):
    """Terms are finite and positive for every runnable cell, at least
    the model FLOPs, and decode moves more bytes than the H100 computes
    in the same time; nothing crosses pods on one pod."""
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for shape in cfg.shapes():
            a = analytic_terms(arch, shape, mesh, micro=4)
            assert a["flops_dev"] > 0 and np.isfinite(a["flops_dev"])
            assert a["bytes_dev"] > 0 and np.isfinite(a["bytes_dev"])
            assert a["coll_bytes"] >= a["cross_bytes"] >= 0
            assert a["flops_dev"] >= a["model_flops_dev"] * 0.99
            if configs.SHAPES[shape].kind == "decode":
                assert a["bytes_dev"] / roofline.HBM_BW > \
                    a["flops_dev"] / roofline.PEAK_FLOPS["bfloat16"]
            if mesh != "multi":
                assert a["cross_bytes"] == 0
            if mesh == (1, 1):
                assert a["coll_bytes"] == 0


def test_train_flops_scale_with_tokens():
    a1 = analytic_terms("qwen3-14b", "train_4k", "single", micro=4)
    a2 = analytic_terms("qwen3-14b", "prefill_32k", "single", micro=1)
    # train does fwd+bwd (+remat): ≥3× prefill per token; token counts
    # equal (256·4096 vs 32·32768)
    assert a1["flops_dev"] > 2.5 * a2["flops_dev"]


def test_microbatches_increase_gather_traffic():
    lo = analytic_terms("command-r-35b", "train_4k", "single", micro=2)
    hi = analytic_terms("command-r-35b", "train_4k", "single", micro=16)
    assert hi["coll_bytes"] > lo["coll_bytes"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_analytic_terms_equal_jax(mesh):
    """The closed forms are the JAX package's, counted on the port's
    configs: FLOPs, HBM bytes and collective bytes (ICI + DCI there,
    the cross-pod share equal to DCI) for every arch and shape; only the
    rates they are priced at differ."""
    import os
    os.environ.setdefault("REPRO_DRYRUN_NO_FAKE_DEVICES", "1")
    from benchmarks import roofline as jroofline
    for arch in configs.ARCHS:
        for shape in configs.get(arch).shapes():
            for micro in (1, 4):
                got = analytic_terms(arch, shape, mesh, micro)
                want = jroofline.analytic_terms(arch, shape, mesh, micro)
                for k_got, k_want in (("flops_dev", "flops_dev"),
                                      ("bytes_dev", "bytes_dev"),
                                      ("cross_bytes", "dci_bytes"),
                                      ("model_flops_dev",
                                       "model_flops_dev")):
                    assert math.isclose(got[k_got], want[k_want],
                                        rel_tol=1e-12), (arch, shape, k_got)
                assert math.isclose(
                    got["coll_bytes"], want["ici_bytes"] + want["dci_bytes"],
                    rel_tol=1e-12, abs_tol=1e-6), (arch, shape)


def _record(**over):
    rec = dict(arch="qwen3-14b", shape="train_4k", mesh="single",
               status="ok", variant=None, cfg_overrides={},
               grad_acc_dtype="float32", mesh_shape=[16, 16], kind="train",
               global_batch=256, seq_len=4096, microbatches=16,
               memory=dict(argument_bytes=1, temp_bytes=2, peak_bytes=3),
               cost=dict(flops_per_device=int(989e12 + 67e12),
                         flops_by_dtype={"bfloat16": int(989e12),
                                         "float32": int(67e12)}),
               collectives={"all-gather": dict(
                   count=1, bytes=4, wire_bytes=300,
                   cross_host_wire_bytes=100),
                   "all-reduce": dict(count=1, bytes=4, wire_bytes=100,
                                      cross_host_wire_bytes=0)})
    rec.update(over)
    return rec


def test_cell_roofline_prices_a_record():
    """Compute from the record's FLOPs by dtype (989 TFLOP/s bf16, 67
    f32: here 1 s each), memory from the closed form's bytes at 3.35
    TB/s, collectives from the closed form's bytes, a quarter of them
    (the record's cross-host share of wire bytes) at 50 GB/s and the rest
    at 450 GB/s; the floor is the largest."""
    r = roofline.cell_roofline(_record())
    a = analytic_terms("qwen3-14b", "train_4k", (16, 16), 16)
    assert r["compute_s"] == pytest.approx(2.0, rel=1e-9)
    assert r["memory_s"] == pytest.approx(a["bytes_dev"] / 3.35e12)
    total = a["coll_bytes"]
    assert r["cross_host_bytes"] == pytest.approx(total / 4)
    assert r["collective_s"] == pytest.approx(
        0.75 * total / 450e9 + 0.25 * total / 50e9)
    assert r["floor_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
    assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                key=r.get)
    assert roofline.cell_roofline(_record(status="skipped")) is None
    # one card: no collective, compute and memory only
    one = roofline.cell_roofline(_record(
        mesh_shape=[1, 1], global_batch=2, microbatches=1, collectives={}))
    assert one["collective_s"] == 0 and one["floor_s"] > 0


def test_analyze_reads_and_writes_records(tmp_path):
    art = tmp_path / "dryrun_torch"
    art.mkdir()
    (art / "a.json").write_text(json.dumps(_record()))
    (art / "b.json").write_text(json.dumps(_record(
        arch="llama4-scout-17b-a16e", cfg_overrides={})))
    (art / "c.json").write_text(json.dumps(dict(
        arch="hubert-xlarge", shape="decode_32k", mesh="single",
        status="skipped", reason="encoder-only")))
    out = tmp_path / "roofline_torch.json"
    rows = roofline.analyze(str(art), str(out))
    assert [r["cell"] for r in rows] == [
        "qwen3-14b|train_4k|single", "llama4-scout-17b-a16e|train_4k|single"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    only = roofline.analyze(str(art), None,
                            cells={("qwen3-14b", "train_4k", "single")})
    assert len(only) == 1
    table = roofline.markdown_table(rows)
    assert table.count("\n") == 3 and "qwen3-14b|train_4k|single" in table


def test_accounting_counts_cross_host_wire_bytes():
    """On placeholder ranks (8 a host): an all-reduce over ranks 0-7
    stays in host 0; over ranks 0-15 and over {0, 8} it spans two hosts.
    Ring wire bytes: 2·n·(g-1)/g for an all-reduce of n bytes over g."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    dryrun.fake_world(16)
    groups = {g: dist.new_group(list(r)) for g, r in (
        ("host", range(8)), ("two", range(16)), ("pair", (0, 8)))}
    acct = dryrun.Accounting()
    x = torch.empty(1024, dtype=torch.float32, device="meta")
    n = 4096
    with acct:
        for g in groups.values():
            funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
    rec = acct.collectives["all-reduce"]
    host, two, pair = 2 * n * 7 // 8, 2 * n * 15 // 16, 2 * n // 2
    assert rec["count"] == 3
    assert rec["wire_bytes"] == host + two + pair
    assert rec["cross_host_wire_bytes"] == two + pair
    assert rec["cross_pod_wire_bytes"] == 0          # no pod size given


def test_accounting_counts_flops_by_dtype():
    a = torch.empty(8, 16, device="meta", dtype=torch.bfloat16)
    b = torch.empty(16, 4, device="meta", dtype=torch.bfloat16)
    acct = dryrun.Accounting()
    with acct:
        a @ b
        a.float() @ b.float()
    assert acct.flops_by_dtype == {"bfloat16": 2 * 8 * 16 * 4,
                                   "float32": 2 * 8 * 16 * 4}
    assert acct.flops == sum(acct.flops_by_dtype.values())
