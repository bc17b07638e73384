"""The port's roofline arithmetic and report against the JAX package's:
``active_param_count`` and ``model_flops`` for every arch at FULL, the
ring wire factors and ``collective_bytes`` against the HLO parser on the
same collectives, and the report's two markdown tables rendered by both
packages from the same records."""
import json

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import report, roofline
from repro_torch.models import build_model


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_jax(arch):
    model = build_model(get_config(arch))
    jmodel = jax_build_model(jax_get_config(arch))
    assert roofline.active_param_count(model) == \
        jax_roofline.active_param_count(jmodel)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(model, shape) == \
            jax_roofline.model_flops(jmodel, JAX_SHAPES[name])


def test_wire_factors_are_the_ring_formulas_of_jax():
    assert set(roofline._WIRE_FACTOR) == set(jax_roofline._WIRE_FACTOR)
    for kind, f in roofline._WIRE_FACTOR.items():
        for n in (1, 2, 16, 32, 256, 512):
            assert f(n) == jax_roofline._WIRE_FACTOR[kind](n), (kind, n)


def test_collective_bytes_equals_the_hlo_parser_on_the_same_collectives():
    # (kind, HLO result type, its bytes, group size)
    ops = [("all-gather", "bf16[16,1024]", 2 * 16 * 1024, 16),
           ("all-gather", "f32[2,8,128]", 4 * 2 * 8 * 128, 2),
           ("reduce-scatter", "bf16[64,5120]", 2 * 64 * 5120, 16),
           ("all-reduce", "f32[8,4096,5120]", 4 * 8 * 4096 * 5120, 16),
           ("all-reduce", "bf16[1024]", 2 * 1024, 32),
           ("all-to-all", "bf16[4,256]", 2 * 4 * 256, 16),
           ("collective-permute", "f32[128]", 4 * 128, 2)]
    lines = [f"  %x{i} = {t}{{0}} {kind}(%p{i}), "
             f"replica_groups=[{512 // g},{g}]<=[512]"
             for i, (kind, t, _, g) in enumerate(ops)]
    want = jax_roofline.parse_collective_bytes("\n".join(lines), 512)
    got = roofline.collective_bytes([(k, b, g) for k, _, b, g in ops], 512)
    assert got["counts"] == want["counts"]
    assert got["by_kind"] == pytest.approx(want["by_kind"], rel=1e-15)
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"],
                                                    rel=1e-15)
    # a group of None spans every device; empty results are skipped
    spanning = roofline.collective_bytes([("all-reduce", 100, None),
                                          ("all-gather", 0, 4)], 8)
    assert spanning["by_kind"]["all-reduce"] == 100 * 2 * 7 / 8
    assert spanning["counts"]["all-gather"] == 0


def test_hw_holds_the_h100_data_sheet_figures():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 50e9}
    cost = {"flops": 989e12, "bytes accessed": 6.7e12}
    coll = {"total_wire_bytes": 25e9}
    t = roofline.roofline_terms(cost, coll, 1)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1.0, 2.0,
                                                                  0.5)
    assert t["bottleneck"] == "memory"


def _record(arch, shape, mesh, frac, peak, bottleneck="compute"):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "memory": {"peak_est_bytes": peak},
            "roofline": {"compute_s": 1.23456, "memory_s": 0.5,
                         "collective_s": 0.25, "bottleneck": bottleneck,
                         "useful_flops_ratio": 0.875,
                         "roofline_fraction": frac}}


def test_report_renders_the_jax_packages_tables(tmp_path, monkeypatch):
    files = {
        "qwen2.5-32b_train_4k_single": _record("qwen2.5-32b", "train_4k",
                                               "single", 0.5, 40 * 2**30),
        "qwen2.5-32b_train_4k_single_fsdp": _record(
            "qwen2.5-32b", "train_4k", "single", 0.625, 30 * 2**30, "memory"),
        "gemma-7b_decode_32k_multi": _record("gemma-7b", "decode_32k",
                                             "multi", 0.01, 3 * 2**30),
        "gemma-7b_long_500k_single": {"arch": "gemma-7b",
                                      "shape": "long_500k", "mesh": "single",
                                      "skipped": True, "reason": "x"},
        "dbrx-132b_prefill_32k_multi": {"arch": "dbrx-132b",
                                        "shape": "prefill_32k",
                                        "mesh": "multi",
                                        "error": "ValueError: " + "e" * 80},
    }
    for stem, rec in files.items():
        (tmp_path / f"{stem}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(report, "RESULTS", tmp_path)
    monkeypatch.setattr(jax_report, "RESULTS", tmp_path)
    roof = report.roofline_markdown()
    assert roof == jax_report.roofline_markdown()
    assert roof.count("\n") == 1 + 4  # the tagged variant is not a row
    perf = report.perf_markdown()
    assert perf == jax_report.perf_markdown()
    assert "| qwen2.5-32b:train_4k:single | fsdp |" in perf


def test_report_main_prints_without_experiments_md(tmp_path, monkeypatch, capsys):
    (tmp_path / "a_train_4k_single.json").write_text(json.dumps(
        _record("a", "train_4k", "single", 0.5, 2**30)))
    monkeypatch.setattr(report, "RESULTS", tmp_path)
    monkeypatch.setattr(report, "EXP", tmp_path / "EXPERIMENTS.md")
    report.main(["--inject"])
    out = capsys.readouterr().out
    assert out.startswith("| arch | shape | mesh |") and "| a | train_4k |" in out
    assert not (tmp_path / "EXPERIMENTS.md").exists()
