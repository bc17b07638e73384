"""ESDP on the fig-6 c_hi = 6 instance (a plane over one block's shared
memory, so the ``cuda`` backend takes the tiled path: on the CPU the
auto-tiled host loop with the plain versions of the fused kernel) against
the JAX package's ESDP slot for slot, on the JAX draws and schedule —
the parity rules of ``tests/test_torch_env.py``, whose helpers it uses.

A file of its own: it is the slowest case of those parity tests, and the
tier-1 command spreads whole files over its workers.
"""
import dataclasses

from repro.core import build_tables as jax_build_tables
from repro.core import generate_instance as jax_generate_instance
from repro.core import simulate as jax_simulate
from repro.core import esdp as jax_esdp
from repro.core import stats as jax_stats
from repro_torch.core import build_tables, instance_from_arrays, simulate
from repro_torch.core import esdp
from repro_torch.core import stats
from repro_torch.core.solvers import Solver, get_solver
from repro_torch.kernels.budgeted_dp import LAUNCHES, SMEM_LIMIT_BYTES

from test_torch_env import (_assert_parity, _jax_draws, _jax_schedule,
                            _recording)


def test_esdp_fig6_c_hi6_tiled_matches_jax_slot_for_slot():
    """ESDP on the fig-6 c_hi = 6 instance (a 721 × 126 plane at T = 150,
    over one block's shared memory) through the ``cuda`` backend — on the
    CPU the auto-tiled host loop with the plain versions of the fused
    kernel — makes the JAX ESDP's decisions (``reference`` backend) every
    slot on injected draws and schedule.  Every solve gets u_max =
    ``u_max_for_horizon``, as in the JAX ESDP, and its Υ̂ stays under it."""
    jinst = jax_generate_instance(seed=2, c_lo=1, c_hi=6)
    inst = instance_from_arrays(**dataclasses.asdict(jinst))
    jtables, tables = (jax_build_tables(jinst.A, jinst.c),
                       build_tables(inst.A, inst.c))
    T, seed = 150, 42
    s_cap = stats.s_cap_for_horizon(T, inst.m)
    assert 4 * (s_cap + 1) * tables.n_states > SMEM_LIMIT_BYTES
    seen = []
    cuda = get_solver("cuda")

    def recording(ups, sig, tables_, s_cap_, s_limit, allowed, u_max):
        seen.append((int(ups.max()), u_max))
        return cuda(ups, sig, tables_, s_cap_, s_limit, allowed, u_max)

    jp = jax_esdp.make_esdp_policy(jinst, T, tables=jtables)
    tp = esdp.make_esdp_policy(inst, T, tables=tables,
                               solver=Solver("recording", recording,
                                             accepts_batch=True))
    want = jax_simulate(jinst, _recording(jp, T, inst.n_edges), T,
                        seed=seed, tables=jtables)
    before = dict(LAUNCHES)
    got = simulate(inst, tp, T, tables=tables, device="cpu",
                   draws=_jax_draws([seed], T, inst.n_ports, inst.n_edges),
                   schedule=_jax_schedule(T, inst.m, jax_stats.delta_default,
                                          jax_stats.g_default))
    _assert_parity(got, want.policy_final[1], want)
    assert LAUNCHES == before  # plain versions on the CPU count nothing
    u_max = stats.u_max_for_horizon(T, inst.m)
    assert len(seen) == T and {u for _, u in seen} == {u_max}
    assert max(top for top, _ in seen) < u_max
