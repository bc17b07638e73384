"""The port's dry run on the CPU: the depth fit of ``cost_model`` against a
direct full-depth trace for each family system, the dry run's FLOP count
against ``FlopCounterMode`` over a real CPU step, the kernels' meta
route (nothing launched, the plain versions never reached, the counted
work equal to each kernel's formula), and one REDUCED multi-pod cell
planned in a subprocess (the fake process group is global to a
process)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import Shape, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import dryrun
from repro_torch.launch.cost_model import cost_variants, solve_costs
from repro_torch.models import build_model
from repro_torch.optim import AdamW, OptState
from repro_torch.runtime import TrainState, make_train_step
from repro_torch.runtime.sharding import make_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Mesh:
    """Axis names and sizes: all the dry run's arithmetic reads."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


# one arch a family system of cost_model (gemma3: local and global layers)
SYSTEMS = ["qwen2.5-32b", "gemma3-27b", "dbrx-132b", "deepseek-v3-671b",
           "qwen2-vl-72b", "mamba2-2.7b", "zamba2-7b", "whisper-medium"]


@pytest.mark.parametrize("arch", SYSTEMS)
def test_depth_fit_equals_a_full_depth_trace(arch):
    cfg = get_config(arch, reduced=True)
    shape = Shape("t", 48, 4, "train")
    rules = make_rules(_Mesh(), "train")
    variants, solve = cost_variants(cfg, shape.seq_len, shape.kind)
    vals = [dryrun.step_cost(build_model(v), shape, rules, n_devices=4)
            for v in variants]
    fit = solve_costs(vals, solve)
    direct = dryrun.step_cost(build_model(cfg), shape, rules, n_devices=4)
    assert set(fit) == set(direct)
    for k, v in direct.items():
        assert fit[k] == pytest.approx(v, rel=1e-12, abs=1e-9), k
    for k in ("flops", "bytes accessed"):
        assert fit[k] == direct[k] and direct[k] > 0, k  # integers, exact
    assert direct["wire:total"] > 0


def _real_batch(cfg, B, S, g):
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S + 1), generator=g)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(B, cfg.enc_len, cfg.d_model,
                                          generator=g)
    return batch


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "mamba2-2.7b",
                                  "whisper-medium"])
def test_dry_run_flops_equal_flop_counter_on_a_real_cpu_step(arch):
    cfg = get_config(arch, reduced=True)
    B, S = 2, 64
    rec = dryrun.plan_cell(cfg, Shape("t", S, B, "train"), _Mesh())
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, trainable=True)
    opt = AdamW()
    state = TrainState(params, opt.init(params), None)
    step = make_train_step(model, opt, remat="full")
    with FlopCounterMode(display=False) as fc:
        step(state, _real_batch(cfg, B, S, g))
    assert rec["cost_global"]["flops"] == fc.get_total_flops()
    # a device of the 2 x 2 mesh holds less than the whole state
    assert rec["n_devices"] == 4
    state_bytes = sum(t.nbytes for t in (*params.parameters(),
                                         state.opt.step,
                                         *state.opt.m.values(),
                                         *state.opt.v.values()))
    mem = rec["memory"]
    assert mem["params_bytes"] + mem["opt_state_bytes"] < state_bytes


def test_one_device_plan_holds_the_whole_state():
    cfg = get_config("qwen2.5-32b", reduced=True)

    class One:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    rec = dryrun.plan_cell(cfg, Shape("t", 32, 2, "train"), One())
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), trainable=True)
    opt = AdamW().init(params)
    want = sum(t.nbytes for t in (*params.parameters(), opt.step,
                                  *opt.m.values(), *opt.v.values()))
    mem = rec["memory"]
    assert mem["params_bytes"] + mem["opt_state_bytes"] == want
    assert mem["batch_bytes"] == 2 * 33 * 4  # int32 tokens
    assert mem["peak_est_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > sum(p.nbytes for p in params.parameters())
    # remat "none" keeps every layer's activations: a larger peak where
    # they outweigh the optimizer's temporaries
    long, rules = Shape("t", 512, 8, "train"), make_rules(One(), "train")
    full, none = (dryrun.step_memory(build_model(cfg), long, rules, r)
                  for r in ("full", "none"))
    assert none["temp_bytes"] > full["temp_bytes"]
    assert rec["collectives"]["total_wire_bytes"] == 0


def test_the_optimizer_state_is_planned_from_the_optimizer(monkeypatch):
    """An optimizer that keeps no moments plans its step count alone as
    state, and a lower peak: the argument sum and the trace both read the
    optimizer the step runs."""
    cfg = get_config("qwen2.5-32b", reduced=True)
    shape = Shape("t", 32, 2, "train")

    class One:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    class NoMoments(AdamW):
        def init(self, params):
            return OptState(step=super().init(params).step, m={}, v={})

        def update(self, grads, state, params):
            named = dict(params.named_parameters())
            with torch.no_grad():
                for name, g in grads.items():
                    named[name].sub_(g)
            return params, OptState(state.step + 1, {}, {}), \
                torch.zeros((), device=state.step.device)

    full = dryrun.plan_cell(cfg, shape, One())["memory"]
    monkeypatch.setattr(dryrun, "AdamW", NoMoments)
    bare = dryrun.plan_cell(cfg, shape, One())["memory"]
    assert bare["opt_state_bytes"] == 4  # the int32 step
    # f32 m and v, each the bytes of the (REDUCED, f32) parameters
    assert full["opt_state_bytes"] == 4 + 2 * bare["params_bytes"]
    assert bare["argument_bytes"] == (full["argument_bytes"]
                                      - full["opt_state_bytes"] + 4)
    assert bare["temp_bytes"] < full["temp_bytes"]


@pytest.fixture
def no_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version was reached")
    for mod, name in ((fa_ref, "flash_attention_ref"),
                      (fa_ref, "flash_attention_bwd_ref"),
                      (ssd_ref, "ssd_ref"), (ssd_ref, "ssd_bwd_ref")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("case", [
    # B, Sq, Sk, H, KH, hd, vh, causal, window, dtype
    (2, 64, 64, 8, 2, 128, 128, True, 0, torch.bfloat16),
    (1, 40, 96, 4, 4, 192, 128, True, 16, torch.float32),
    (3, 17, 50, 6, 3, 64, 64, False, 0, torch.bfloat16)])
def test_attention_on_meta_launches_nothing_and_counts_its_formula(
    case, no_plain_versions
):
    B, Sq, Sk, H, KH, hd, vh, causal, window, dt = case
    meta = dict(device="meta", dtype=dt)
    q = torch.empty(B, Sq, H, hd, **meta)
    k = torch.empty(B, Sk, KH, hd, **meta)
    v = torch.empty(B, Sk, KH, vh, **meta)
    before = dict(fa.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        o, lse = fa.flash_attention(q, k, v, scale=0.1, causal=causal,
                                    window=window, return_lse=True)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse,
                                            torch.empty_like(o), scale=0.1,
                                            causal=causal, window=window)
    assert fa.LAUNCHES == before
    assert o.shape == (B, Sq, H, vh) and o.device.type == "meta"
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    size = torch.finfo(dt).bits // 8
    assert fwd == fa.fwd_work(B, Sq, Sk, H, KH, hd, vh, causal, window,
                              size, True)[0]
    assert fc.get_total_flops() == fa.bwd_work(B, Sq, Sk, H, KH, hd, vh,
                                               causal, window, size)[0]
    # the pairs: every (query, key) a causal window leaves, by the loop
    w = window or Sk
    loop = (sum(min(i + 1 + Sk - Sq, w) for i in range(Sq)) if causal
            else Sq * Sk)
    assert fa.pairs(Sq, Sk, causal, window) == loop
    # the kernels' limits hold on the meta route too
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(*(t[..., :12].contiguous() for t in (q, k, v)),
                           scale=0.1)


@pytest.mark.parametrize("shape", [(2, 256, 4, 64, 128, 128),
                                   (1, 100, 3, 32, 16, 32)])
def test_ssd_on_meta_launches_nothing_and_counts_its_formula(shape, no_plain_versions):
    B, S, H, P, N, Q = shape
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty(B, S, H, P, **meta)
    dt = torch.empty(B, S, H, **meta)
    A = torch.empty(H, **meta)
    Bm = torch.empty(B, S, N, **meta)
    before = dict(ssd.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        y, st, states, cum = ssd.ssd_scan_saved(x, dt, A, Bm, Bm, Q)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        grads = ssd.ssd_bwd(x, dt, A, Bm, Bm, Q, torch.empty_like(y), None,
                            states, cum)
    assert ssd.LAUNCHES == before
    n_chunks, Qp = -(-S // Q), -(-Q // 16) * 16
    assert states.shape == (B, H, n_chunks, N, P)
    assert cum.shape == (B, H, n_chunks, Qp, 2)
    assert [g.shape for g in grads] == [x.shape, dt.shape, A.shape, Bm.shape,
                                        Bm.shape]
    assert fwd == ssd.scan_work(B, S, H, P, N, Q)[0]
    assert fc.get_total_flops() == ssd.bwd_work(B, S, H, P, N, Q)[0]
    with pytest.raises(ValueError, match="limit of 128"):
        long = torch.empty(B, 256, H, P, **meta)
        lb = torch.empty(B, 256, N, **meta)
        ssd.ssd_scan(long, torch.empty(B, 256, H, **meta), A, lb, lb, 256)
    with pytest.raises(ValueError, match="P <= 64"):
        wide = torch.empty(B, S, H, 128, **meta)
        ssd.ssd_bwd(wide, dt, A, Bm, Bm, Q, torch.empty_like(wide))


def test_dry_run_memory_counts_the_kernels_scratch(no_plain_versions):
    """The meta route allocates what the card allocates: the SSD backward's
    scratch makes the peak of a trace over it larger than the gradients."""
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty(2, 256, 8, 64, **meta)
    dt = torch.empty(2, 256, 8, **meta)
    A = torch.empty(8, **meta)
    Bm = torch.empty(2, 256, 128, **meta)
    y, _, states, cum = ssd.ssd_scan_saved(x, dt, A, Bm, Bm, 128)
    tracker = dryrun._LiveBytes([x, dt, A, Bm, y, states, cum])
    with tracker:
        grads = ssd.ssd_bwd(x, dt, A, Bm, Bm, 128, y, None, states, cum)
    grad_bytes = sum(g.nbytes for g in grads)
    assert tracker.live == grad_bytes  # the scratch is gone again
    scratch = states.nbytes + 2 * ssd.bwd_shares(8) * 2 * 256 * 128 * 4 + \
        2 * 8 * 2 * 4
    assert tracker.peak == grad_bytes + scratch


_CELL_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.runtime import sharding

    hooked = []  # the axes the models' sharding hook is called with
    hook = sharding.Rules.__call__

    def recording(self, x, axes):
        hooked.append(list(axes))
        return hook(self, x, axes)
    sharding.Rules.__call__ = recording

    full, small = get_config("gemma-7b"), get_config("gemma-7b", reduced=True)
    overrides = {f.name: getattr(small, f.name)
                 for f in dataclasses.fields(small)
                 if getattr(small, f.name) != getattr(full, f.name)}
    rec = lower_cell("gemma-7b", "decode_32k", multi_pod=True,
                     config_overrides=overrides)
    out = {
        "ok": "roofline" in rec and "error" not in rec,
        "n_devices": rec.get("n_devices"),
        "flops": rec.get("roofline", {}).get("flops_per_device", 0) > 0,
        "wire": rec.get("roofline", {}).get("wire_bytes_per_device", -1) >= 0,
        "mem": rec.get("memory", {}).get("peak_est_bytes", 0) > 0,
        "cache": rec.get("memory", {}).get("cache_bytes", 0) > 0,
        # the decode traced attention's cache pin (attention.py:168-171)
        "hook": ["batch", "cache_seq", "kv_heads", None] in hooked,
    }
    print(json.dumps(out))
""")


def test_dryrun_cell_multi_pod_reduced():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _CELL_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["n_devices"] == 512
    assert res["flops"] and res["wire"] and res["mem"] and res["cache"]
    assert res["hook"], "the decode cell did not trace through the rules hook"
