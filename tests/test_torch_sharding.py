"""The port's sharding rules, compose plans and mesh refusals against the
reference, with no ranks: the rules read only ``axis_names`` and a
``shape`` dict, so both packages run them on the duck-typed meshes of
``tests/test_sharding_rules.py``.

The reference's rule functions wrap each spec in a ``NamedSharding``,
which needs devices; here its ``NamedSharding`` is replaced (in the
reference module's namespace, for the test's duration) by a holder of
the spec, so its trees come from ``spec_for(shape, leaf_roles(...))``
over ``param_shapes``/``adapter_shapes`` exactly as it computes them.
The port's trees must equal them leaf for leaf, for every registered
arch on four meshes. Also here: ``ComposeSharding``'s derived specs and
``plan_compose``'s route, the refusals of ``launch/mesh.py``, and the
small ports of this slice (``compose_naive``, ``select_tier``,
``DoRAParamSpec``, the gradient compression, ``StragglerMonitor``) on
the reference's own test cases.
"""
import dataclasses
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint.fault import Heartbeat as JHeartbeat
from repro.checkpoint.fault import StragglerMonitor as JMonitor
from repro.configs import get_config as jget_config
from repro.core import adapter as jadapter
from repro.core import compose as jcompose
from repro.core import dispatch as jdispatch
from repro.core import sharding as jsh
from repro.core.config import DoRAConfig as JConfig
from repro.launch import sharding as JS
from repro.models import adapter_shapes as jadapter_shapes
from repro.optim import compression as jcomp
from repro_torch.checkpoint.fault import Heartbeat, StragglerMonitor
from repro_torch.configs import _MODULES, get_config
from repro_torch.core import adapter as tadapter
from repro_torch.core import compose as tcompose
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import sharding as tsh
from repro_torch.core.config import DoRAConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as TS
from repro_torch.models import lm as tlm
from repro_torch.optim import compression as tcomp
from repro_torch.tree import flatten_paths


class FakeMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


ARCHS = sorted(_MODULES)
MESHES = {"pod2_data16_model16": dict(pod=2, data=16, model=16),
          "data16_model16": dict(data=16, model=16),
          "data2_model2": dict(data=2, model=2),
          "data1_model1": dict(data=1, model=1)}


class _Holder:
    """What the reference's rules read of a NamedSharding: its spec."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def ref_rules(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", _Holder)
    return JS


def _specs(tree):
    """"/"-path → spec as a plain tuple, from either package's tree."""
    out = {}
    for name, leaf in flatten_paths(tree).items():
        spec = leaf.spec if isinstance(leaf, _Holder) else leaf
        out[name] = tuple(spec)
    return out


def _dcfg(cache_base_norm=False):
    return (JConfig(rank=384, alpha=192.0, cache_base_norm=cache_base_norm),
            DoRAConfig(rank=384, alpha=192.0,
                       cache_base_norm=cache_base_norm))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_adapter_rules_match_reference(arch, mesh_name,
                                                 ref_rules):
    """param_sharding and adapter_sharding (training, serving, with the
    cached base term) leaf by leaf, and the shape trees they walk."""
    mesh = FakeMesh(**MESHES[mesh_name])
    jm, tm = jget_config(arch), get_config(arch)
    assert _specs(TS.param_sharding(tm, mesh)) == _specs(
        ref_rules.param_sharding(jm, mesh))
    for cache in (False, True):
        jd, td = _dcfg(cache)
        for serving in (False, True):
            assert _specs(TS.adapter_sharding(tm, td, mesh,
                                              serving=serving)) == _specs(
                ref_rules.adapter_sharding(jm, jd, mesh, serving=serving))
        want = {k: tuple(v.shape) for k, v in flatten_paths(
            jadapter_shapes(jm, jd)).items()}
        got = {k: tuple(v.shape) for k, v in flatten_paths(
            tlm.adapter_shapes(tm, td)).items()}
        assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_rules_match_reference(arch, mesh_name, ref_rules):
    """row_parallel_b_axes, activation_spec, batch_spec, cache_sharding
    (rectangular and paged), opt_state_sharding (with and without the
    shapes) and fleet_stack_sharding."""
    mesh = FakeMesh(**MESHES[mesh_name])
    jm, tm = jget_config(arch), get_config(arch)
    jd, td = _dcfg()
    assert TS.row_parallel_b_axes(tm, mesh) == \
        ref_rules.row_parallel_b_axes(jm, mesh)
    for batch, seq in ((1, 1), (2, 2048), (32, 4096), (48, 100)):
        assert tuple(TS.activation_spec(mesh, batch=batch, seq=seq)) == \
            tuple(ref_rules.activation_spec(mesh, batch=batch, seq=seq))
        assert tuple(TS.batch_spec(mesh, batch=batch)) == \
            tuple(ref_rules.batch_spec(mesh, batch=batch))
        for bs in (None, 16):
            assert _specs(TS.cache_sharding(tm, mesh, batch=batch,
                                            block_size=bs)) == _specs(
                ref_rules.cache_sharding(jm, mesh, batch=batch,
                                         block_size=bs))
    t_ad = TS.adapter_sharding(tm, td, mesh)
    j_ad = ref_rules.adapter_sharding(jm, jd, mesh)
    for with_shapes in (False, True):
        t_sh = tlm.adapter_shapes(tm, td) if with_shapes else None
        j_sh = jadapter_shapes(jm, jd) if with_shapes else None
        assert _specs(TS.opt_state_sharding(t_ad, mesh, t_sh)) == _specs(
            ref_rules.opt_state_sharding(j_ad, mesh, j_sh))
    serving = ref_rules.adapter_sharding(jm, jd, mesh, serving=True)
    assert _specs(TS.fleet_stack_sharding(
        TS.adapter_sharding(tm, td, mesh, serving=True), mesh)) == _specs(
        ref_rules.fleet_stack_sharding(serving, mesh))


def test_boundary_constraint_carries_the_reference_plan():
    """make_boundary_constraint's spec and .plan equal the reference's
    (its plan's derived specs included) on every duck mesh."""
    for axes in MESHES.values():
        mesh = FakeMesh(**axes)
        for b_axes in ((), ("pod",) if "pod" in axes else ()):
            t = TS.make_boundary_constraint(mesh, batch=32, seq=4096,
                                            b_dout_axes=b_axes)
            want = jsh.plan_for_output(
                mesh, JS.activation_spec(mesh, batch=32, seq=4096),
                b_dout_axes=b_axes)
            assert tuple(t.spec) == tuple(want.out_spec)
            _same_plan(t.plan, want, 4096)


OUT_SPECS = [(None, "model"), ("data", None), ("data", "model"),
             (("data", "model"), None), ("data", "model", None),
             (None, None, "model"), (("pod", "data"), "model"),
             (("pod", "data"), None, "model"), ("model", None), (None,),
             ()]


def _same_plan(t, j, d_out):
    for attr in ("row_axes", "dout_axes", "dout_shards", "row_shards"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("h_spec", "b_spec", "vec_spec"):
        assert tuple(getattr(t, attr)) == tuple(getattr(j, attr)), attr
    assert t.flat2d() == j.flat2d()
    for n in (d_out, 128, 256, 384, 512, 1000, 3584, 18944):
        assert t.local_dout(n) == j.local_dout(n)
        assert t.kernel_expressible(n) == j.kernel_expressible(n), n


@pytest.mark.parametrize("b_axes", [(), ("data",), ("pod",), ("model",)])
@pytest.mark.parametrize("spec", OUT_SPECS, ids=str)
def test_compose_sharding_derived_specs_match_reference(spec, b_axes):
    for axes in MESHES.values():
        if any(a not in axes for e in spec + (b_axes,)
               for a in ((e,) if isinstance(e, str) else (e or ()))):
            continue
        mesh = FakeMesh(**axes)
        t = tsh.plan_for_output(mesh, spec, b_dout_axes=b_axes)
        j = jsh.plan_for_output(mesh, JP(*spec), b_dout_axes=b_axes)
        _same_plan(t, j, 4096)
        assert tsh.as_compose_sharding(t) is t
        assert tsh.as_compose_sharding(TS.make_boundary_constraint(
            mesh, batch=2, seq=16)).out_spec == tuple(
            JS.activation_spec(mesh, batch=2, seq=16))


def test_compose_sharding_checks_local_shards():
    """The port's constraints check a local shard's shape against the
    plan (there is no GSPMD to place it)."""
    mesh = FakeMesh(data=2, model=4)
    plan = tsh.plan_for_output(mesh, ("data", "model"))
    y = torch.zeros(8, 32)
    assert plan(y, (16, 128)) is y
    with pytest.raises(ValueError, match="does not agree"):
        plan(y, (16, 64))
    with pytest.raises(ValueError, match="cannot constrain"):
        plan(torch.zeros(4))
    assert plan.constrain_h(torch.zeros(8, 16), (16, 16)).shape == (8, 16)
    assert plan.constrain_vec(torch.zeros(32), (128,)).shape == (32,)
    with pytest.raises(ValueError, match="unstacked"):
        plan.constrain_b(torch.zeros(2, 32, 16))


@pytest.fixture
def ref_auto_on_accelerator(monkeypatch):
    """The reference's auto mode routes by its crossover only where its
    accelerator probe passes; the port's plan runs for CUDA tensors."""
    tpu = jdispatch.DISPATCH_TABLE["tpu"]
    monkeypatch.setitem(jdispatch.DISPATCH_TABLE, "tpu",
                        dataclasses.replace(tpu, available=lambda: True))
    for name in ("REPRO_FORCE_TIER", "REPRO_DORA_MODE",
                 "REPRO_TORCH_FORCE_TIER"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("mode", ["auto", "fused"])
@pytest.mark.parametrize("spec", [None, (None, "model"), ("data", "model"),
                                  ("data", "model", None),
                                  (None, None, "model")], ids=str)
def test_plan_compose_route_matches_reference(spec, mode,
                                              ref_auto_on_accelerator):
    """Tier, matmul fusion and the attached plan of plan_compose under a
    plan, on the whole shape, for both packages' configs."""
    for axes in (MESHES["data2_model2"], MESHES["data16_model16"]):
        mesh = FakeMesh(**axes)
        for b_axes in ((), ("data",)):
            t_plan = j_plan = None
            if spec is not None:
                t_plan = tsh.plan_for_output(mesh, spec, b_dout_axes=b_axes)
                j_plan = jsh.plan_for_output(mesh, JP(*spec),
                                             b_dout_axes=b_axes)
            for rows, d_out, rank, training in (
                    (4096, 3584, 384, True), (4096, 18944, 384, False),
                    (2048, 3584, 384, True), (4096, 512, 384, True),
                    (64, 4096, 16, True), (4100, 4096, 384, True),
                    (8192, 2048, 640, True), (4096, 3584, None, True),
                    (32768, 18944, 128, False), (16, 256, 16, True)):
                t = tdispatch.plan_compose(
                    DoRAConfig(rank=384, mode=mode), training=training,
                    rows=rows, d_out=d_out, rank=rank, sharding=t_plan,
                    device="cuda")
                j = jdispatch.plan_compose(
                    JConfig(rank=384, mode=mode), training=training,
                    rows=rows, d_out=d_out, rank=rank, sharding=j_plan)
                case = (axes, spec, b_axes, rows, d_out, rank, training)
                assert t.tier.value == j.tier.value, case
                assert t.matmul_fused == j.matmul_fused, case
                assert (t.sharding is None) == (j.sharding is None), case
                assert tdispatch.select_tier(
                    DoRAConfig(rank=384, mode=mode), training=training,
                    rows=rows, d_out=d_out).value == jdispatch.select_tier(
                    JConfig(rank=384, mode=mode), training=training,
                    rows=rows, d_out=d_out).value


def test_local_block_shape_refuses_a_ragged_shard():
    """The shard-local compose takes the local shapes the reference's
    ``local_block_shape`` takes and refuses the ones it refuses (a local
    d_out off the 128-lane rule); an accepted local tile runs K6's plain
    version unchanged."""
    from repro.kernels.dora_compose import local_block_shape as jlocal
    from repro_torch.kernels import ops
    from repro_torch.kernels.dora_compose import compose_mm_fwd_plain

    assert jlocal(4096, 3584, row_shards=2, dout_shards=2)[1] % 128 == 0
    gen = torch.Generator().manual_seed(0)
    mesh = FakeMesh(data=2, model=2)
    plan = tsh.plan_for_output(mesh, ("data", "model"))
    base, h = torch.randn(8, 256, generator=gen), torch.randn(8, 16,
                                                              generator=gen)
    B, g = torch.randn(256, 16, generator=gen), torch.rand(256,
                                                           generator=gen)
    got = ops.fused_compose_mm(base, h, B, g, 0.5, sharding=plan)
    assert torch.equal(got, compose_mm_fwd_plain(base, h, B, g - 1.0, 0.5))
    for n, shards in ((3584, 8), (1000, 1), (512, 3)):
        with pytest.raises(ValueError, match="128-lane"):
            jlocal(64, n, dout_shards=shards)
        n_l = -(-n // shards)
        plan = tsh.plan_for_output(FakeMesh(data=1, model=shards),
                                   (None, "model"))
        with pytest.raises(ValueError, match="128-lane"):
            ops.fused_compose_mm(torch.zeros(4, n_l), torch.zeros(4, 8),
                                 torch.zeros(n_l, 8), torch.ones(n_l), 1.0,
                                 sharding=plan)


def test_fused_compose_mm_refuses_b_sharded_beyond_the_output():
    from repro_torch.kernels import ops

    mesh = FakeMesh(data=2, model=2)
    plan = tsh.plan_for_output(mesh, ("data", "model"), b_dout_axes=("data",))
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="inexpressible"):
        ops.fused_compose_mm(x, torch.zeros(4, 8), torch.zeros(128, 8),
                             torch.ones(128), 1.0, sharding=plan)


# --- launch/mesh.py refusals ---------------------------------------------

def test_make_mesh_with_no_device_means_the_card_and_raises_without_one():
    assert not torch.cuda.is_available()
    for make in (lambda: tmesh.make_mesh((1, 2), ("data", "model")),
                 lambda: tmesh.make_debug_mesh(1, 1),
                 lambda: tmesh.make_mesh((1,), ("model",), backend="gloo")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_nccl_is_refused_where_ranks_would_share_a_card(monkeypatch):
    """NCCL refuses two ranks on one card: the mesh says so and names
    gloo; a CPU mesh under NCCL is refused the same way. Nothing switches
    backend on its own. The check reads every rank's (host, card), so a
    world of 2 nodes x 8 cards passes on a node that sees 8 cards, and
    ranks that all stayed on card 0 are refused however many cards the
    node has."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    dev = torch.device("cuda", 0)
    two_nodes = [(f"node{n}", c) for n in range(2) for c in range(8)]
    tmesh.check_backend("nccl", dev, two_nodes)
    tmesh.check_backend("nccl", dev, [("node0", 0)])
    tmesh.check_backend("nccl", dev)
    for placements, first, second in (
            ([("node0", 0), ("node0", 0)], 0, 1),
            ([("node0", c % 8) for c in range(16)], 0, 8),
            ([(f"node{n}", 0) for n in range(2) for _ in range(8)], 0, 1),
            (two_nodes[:15] + [("node1", 3)], 11, 15)):
        with pytest.raises(ValueError, match=f"ranks {first} and {second} "
                           f"would share card .*backend='gloo'"):
            tmesh.check_backend("nccl", dev, placements)
        tmesh.check_backend("gloo", dev, placements)
    with pytest.raises(ValueError, match="backend='gloo'"):
        tmesh.make_mesh((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        tmesh.make_mesh((1, 2), ("data", "model"), device="cpu",
                        backend="mpi")


def test_one_rank_mesh_needs_no_process_group_and_bigger_ones_do():
    mesh = tmesh.make_debug_mesh(1, 1, device="cpu", backend="gloo")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.group(("data", "model")) is None
    assert tmesh.data_axes(mesh) == ("data",)
    assert tmesh.axis_size(mesh, "data", "model", "pod") == 1
    x = torch.arange(4.0)
    assert tsh.psum(x, ("model",), mesh) is x
    assert tsh.all_gather(x, ("model",), mesh, 0) is x
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_debug_mesh(2, 1, device="cpu", backend="gloo")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tmesh.make_production_mesh(device="cpu", backend="gloo")


def test_mesh_step_refuses_what_the_runtime_does_not_honour():
    """FSDP-laid weights, a pod axis and non-dense stacks are refused by
    the mesh step with the ROADMAP item; the rules still cover them."""
    from repro_torch.launch.steps import StepConfig, mesh_layout

    scfg = StepConfig(dora=DoRAConfig(rank=16, alpha=32.0))
    for arch, axes in (("qwen2-7b", dict(data=2, model=2)),
                       ("llama4-scout-17b-a16e", dict(data=2, model=16)),
                       ("qwen2-moe-a2.7b", dict(data=1, model=2)),
                       ("falcon-mamba-7b", dict(data=1, model=2)),
                       ("qwen2-7b", dict(pod=2, data=1, model=2))):
        with pytest.raises(NotImplementedError, match="item 6, second half"):
            mesh_layout(get_config(arch), scfg, FakeMesh(**axes), batch=2,
                        seq=64)
    small = dataclasses.replace(get_config("qwen2-7b"), num_layers=4)
    lay = mesh_layout(small, scfg, FakeMesh(data=2, model=2), batch=2,
                      seq=64)
    assert lay.dp_axes == ("data",) and lay.local_batch == 1
    assert lay.sp.tp == 2 and lay.sp.row_plan.row_axes == ("model",)
    assert lay.sp.col_plan.dout_axes == ("model",)
    assert not lay.sp.col_plan.psum_dh
    with pytest.raises(ValueError, match="does not split"):
        mesh_layout(small, scfg, FakeMesh(data=1, model=2), batch=2, seq=7)


# --- the small ports, on the reference's own cases ------------------------

def test_compose_naive_matches_reference_and_collapses_near_unity():
    rng = np.random.default_rng(0)
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16),
                          (jnp.float32, torch.float32)):
        base = rng.standard_normal((64, 256)).astype(np.float32)
        lora = (0.1 * rng.standard_normal((64, 256))).astype(np.float32)
        g = (1.0 + 0.0015 * rng.standard_normal(256)).astype(np.float32)
        want = np.asarray(jcompose.compose_naive(
            jnp.asarray(base, dtype), jnp.asarray(lora, dtype),
            jnp.asarray(g), 0.5).astype(jnp.float32))
        got = tcompose.compose_naive(
            torch.from_numpy(base).to(tdtype),
            torch.from_numpy(lora).to(tdtype), torch.from_numpy(g),
            0.5).float().numpy()
        assert np.array_equal(got, want)
    g = torch.full((256,), 1.0 + 1e-4)
    base = torch.full((4, 256), 100.0, dtype=torch.bfloat16)
    lora = torch.zeros((4, 256), dtype=torch.bfloat16)
    assert tcompose.compose_naive(base, lora, g, 1.0).abs().max() == 0
    assert tcompose.compose_stable(base, lora, g, 1.0).abs().max() > 0


def test_select_tier_and_param_spec_match_reference():
    for mode in ("eager", "fused"):
        for rows, d_out, training in ((4096, 3584, True), (16, 100, False),
                                      (4096, 18944, False)):
            t = tdispatch.select_tier(DoRAConfig(mode=mode),
                                      training=training, rows=rows,
                                      d_out=d_out)
            j = jdispatch.select_tier(
                JConfig(mode="interpret" if mode == "fused" else mode),
                training=training, rows=rows, d_out=d_out)
            assert t.value == j.value
    spec = tadapter.DoRAParamSpec("stack/l0/mixer/wq", 3584, 3584, 384)
    ref = jadapter.DoRAParamSpec("stack/l0/mixer/wq", 3584, 3584, 384)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.rank = 8
    from repro_torch import core
    for name in ("compose_naive", "select_tier", "factored_norm_sharded"):
        assert getattr(core, name) is not None


def test_bf16_compression_roundtrip():
    g = {"a": torch.tensor([1.0, 2.0, 3.0])}
    out = tcomp.decompress_bf16(tcomp.compress_bf16(g))
    ref = jcomp.decompress_bf16(jcomp.compress_bf16(
        {"a": jnp.asarray([1.0, 2.0, 3.0])}))
    assert out["a"].dtype == torch.float32
    assert np.array_equal(out["a"].numpy(), np.asarray(ref["a"]))


def test_int8_error_feedback_matches_reference_step_by_step():
    """50 steps of the reference's case: q, scale, the dequantized value
    and the residual equal the reference's (one fp32 rounding of a
    division apart at most), and the accumulated error stays within one
    step's quantization error."""
    rng = np.random.default_rng(0)
    raw = [(rng.normal(size=64) * 0.3).astype(np.float32)
           for _ in range(50)]
    ef_t = tcomp.init_error_feedback({"g": torch.zeros(64)})
    ef_j = jcomp.init_error_feedback({"g": jnp.zeros(64)})
    acc_q, acc_raw = np.zeros(64), np.zeros(64)
    for g in raw:
        q_t, s_t, c_t = tcomp.int8_ef_compress({"g": torch.from_numpy(g)},
                                               ef_t)
        q_j, s_j, c_j = jcomp.int8_ef_compress({"g": jnp.asarray(g)}, ef_j)
        assert q_t["g"].dtype == torch.int8
        assert np.abs(q_t["g"].numpy().astype(int)
                      - np.asarray(q_j["g"]).astype(int)).max() <= 1
        assert float(s_t["g"]) == pytest.approx(float(s_j["g"]), rel=1e-6)
        deq_t, ef_t = tcomp.int8_ef_decompress(q_t, s_t, c_t)
        deq_j, ef_j = jcomp.int8_ef_decompress(q_j, s_j, c_j)
        scale = float(s_t["g"])
        assert np.abs(deq_t["g"].numpy() - np.asarray(deq_j["g"])).max() \
            <= scale * 1.0001
        ef_j = {"g": jnp.asarray(ef_t["g"].numpy())}
        acc_q += deq_t["g"].numpy()
        acc_raw += g
    assert np.abs(acc_q - acc_raw).max() <= scale / 2 * 1.5


def test_cross_pod_sync_without_a_pod_axis_is_the_data_mean():
    mesh = tmesh.make_debug_mesh(1, 1, device="cpu", backend="gloo")
    g = {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}
    out, ef = tcomp.cross_pod_sync(g, mesh)
    assert out["a"].dtype == torch.float32 and ef is None
    assert torch.equal(out["a"], torch.tensor([1.0, 2.0]))


def test_heartbeat_and_straggler_monitor(tmp_path):
    """tests/test_checkpoint.py's cases, with either package writing the
    beats and both monitors reading them."""
    for hb in (Heartbeat, JHeartbeat):
        d = str(tmp_path / hb.__module__.replace(".", "_"))
        for i in range(4):
            hb(d, i).beat(step=100)
        hb(d, 4).beat(step=50)
        for mon_cls in (StragglerMonitor, JMonitor):
            mon = mon_cls(d, step_slack=5, dead_after_s=1e9)
            assert mon.stragglers() == ["host_00004.json"]
            assert not mon.healthy(expected_hosts=5)
        hb(d, 4).beat(step=101)
        assert StragglerMonitor(d, step_slack=5,
                                dead_after_s=1e9).healthy(expected_hosts=5)


def test_straggler_dead_host_and_torn_beat(tmp_path):
    d = str(tmp_path / "hb")
    Heartbeat(d, 0).beat(step=10)
    with open(os.path.join(d, "host_00001.json"), "w") as f:
        json.dump({"step": 10, "time": time.time() - 1e4}, f)
    with open(os.path.join(d, "host_00002.json"), "w") as f:
        f.write("{\"step\": 1")
    got, want = (cls(d, dead_after_s=300) for cls in (StragglerMonitor,
                                                      JMonitor))
    assert got.read() == want.read()
    assert got.stragglers(now=time.time()) == want.stragglers(
        now=time.time())
    assert "host_00001.json" in got.stragglers()
    assert StragglerMonitor(str(tmp_path / "none")).stragglers() == []


def test_decode_layout_keeps_the_sequence_whole():
    """The decode mode of the mesh plan: any S, the sequence whole (the
    decode step's S = 1, the verify's window); the residual stream
    whole on every model rank (gather and local rows the identity), the
    row-parallel compose on whole rows and d_out, the column-parallel one
    as in the sequence-parallel mode, the norm's axis the same; the
    sequence-parallel mode still refuses S = 1 on two model ranks, and
    the decode mode keeps every refusal of the rules."""
    from repro_torch.launch.steps import StepConfig, mesh_layout

    scfg = StepConfig(dora=DoRAConfig(rank=16, alpha=32.0))
    small = dataclasses.replace(get_config("qwen2-7b"), num_layers=4)
    mesh = FakeMesh(data=2, model=2)
    lay = mesh_layout(small, scfg, mesh, batch=4, seq=1, decode=True)
    sp = lay.sp
    assert not sp.seq_split and sp.prefix == "tp" and sp.tp == 2
    assert lay.dp_axes == ("data",) and lay.local_batch == 2
    assert tuple(sp.spec) == ("data", None, None)
    assert sp.row_plan.row_axes == () and sp.row_plan.dout_axes == ()
    assert sp.col_plan.dout_axes == ("model",) and not sp.col_plan.psum_dh
    assert sp.norm_axis("wo") == "model" and sp.norm_axis("wq") is None
    x = torch.ones(2, 1, 8)
    assert sp.gather(x) is x and sp.local_rows(x) is x
    sp_train = mesh_layout(small, scfg, mesh, batch=4, seq=64).sp
    assert sp_train.seq_split and sp_train.prefix == "sp"
    with pytest.raises(ValueError, match="does not split"):
        mesh_layout(small, scfg, mesh, batch=4, seq=1)
    window = mesh_layout(small, scfg, mesh, batch=4, seq=2, decode=True)
    assert not window.sp.seq_split and tuple(window.sp.spec) == (
        "data", None, None)
    for arch, axes in (("qwen2-7b", dict(data=2, model=2)),
                       ("falcon-mamba-7b", dict(data=1, model=2)),
                       ("qwen2-7b", dict(pod=2, data=1, model=2))):
        with pytest.raises(NotImplementedError, match="item 6, second half"):
            mesh_layout(get_config(arch), scfg, FakeMesh(**axes), batch=2,
                        seq=1, decode=True)


def test_partial_product_keeps_fp32_sums_and_the_plain_gradients():
    """A row-parallel rank's partial x·wᵀ in bf16 keeps its fp32 sums
    (the upcast operands' exact products, summed in fp32), so two ranks'
    halves added and rounded once are one product rounded once; its
    gradients are the plain bf16 product's, bit for bit; fp32 operands
    and a model axis of one rank take the plain product (and sum no
    norm partials)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=gen).bfloat16()
    w = torch.randn(24, 64, generator=gen).bfloat16()
    y = tsh.partial_product(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.float() @ w.float().T)
    halves = (tsh.partial_product(x[..., :32], w[:, :32])
              + tsh.partial_product(x[..., 32:], w[:, 32:]))
    whole = (x.float() @ w.float().T).bfloat16()
    assert (halves.bfloat16() != whole).float().mean() < 0.01
    dy = torch.randn(3, 5, 24, generator=gen).bfloat16()
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tsh.partial_product(xa, wa).backward(dy.float())
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (xb @ wb.T).backward(dy)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad)
    x32, w32 = x.float(), w.float()
    assert torch.equal(tsh.partial_product(x32, w32), x32 @ w32.T)
    one = TS.make_boundary_constraint(FakeMesh(data=2, model=1), batch=2,
                                      seq=8)
    assert torch.equal(one.partial(x, w), x @ w.T)
    assert one.norm_axis("wo") is None


def test_grouped_and_paged_serving_on_a_mesh_are_refused():
    """The decode step on a mesh refuses what is left to a later slice
    (ROADMAP queue 1 item 6, second half, point 2): a Mamba stack. Static
    groups over a K-stacked folded state, dynamic ones (an int index
    into the same stack) and a paged cache are not refused: on a
    one-rank mesh the grouped decode (two perturbed tenants, one row
    each), the dynamic decode (the rows' positions swapped) and the
    engine's paged cache (``init_cache(mesh=)``, the whole batch's
    tokens) decode as on no mesh, bit for bit."""
    from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                          make_precompute_step)
    from repro_torch.models.config import ModelConfig

    mcfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=64,
                       num_heads=2, num_kv_heads=1, d_ff=128,
                       vocab_size=64, dtype=torch.float32)
    scfg = StepConfig(dora=DoRAConfig(rank=4, alpha=8.0))
    mesh = tmesh.make_debug_mesh(1, 1, device="cpu", backend="gloo")
    gen = torch.Generator().manual_seed(0)
    params = tlm.init_params(gen, mcfg)
    tenants = []
    for _ in range(2):
        ad = tlm.init_adapters(gen, mcfg, params, scfg.dora)
        for name, leaf in flatten_paths(ad).items():
            if name.endswith("/B"):
                leaf.copy_(0.05 * torch.randn(leaf.shape, generator=gen))
        tenants.append(ad)
    tokens = torch.tensor([[3], [7]])
    groups = ((0, 1), (1, 1))
    grouped = []
    for m in (mesh, None):
        pre = make_precompute_step(mcfg, scfg, m, fold_gsb=True)
        stacked = tadapter.stack_adapter_states(
            [pre(params, ad) for ad in tenants], axis=1)
        cache = tlm.init_cache(mcfg, 2, 8, mesh=m)
        cache["len"] = 3
        logits, new = make_decode_step(mcfg, scfg, m, batch=2,
                                       tenant_groups=groups)(
            params, stacked, cache, {"tokens": tokens})
        grouped.append((logits, new["stack"]["l0"]["k"]))
    for got, want in zip(*grouped):
        assert torch.equal(got, want)
    alone = [make_decode_step(mcfg, scfg, batch=1)(
        params, make_precompute_step(mcfg, scfg, fold_gsb=True)(params, ad),
        tlm.init_cache(mcfg, 1, 8) | {"len": 3}, {"tokens": tokens[i:i + 1]})
        [0] for i, ad in enumerate(tenants)]
    for i in range(2):
        assert torch.allclose(grouped[0][0][i:i + 1], alone[i], rtol=0,
                              atol=1e-5 * float(alone[i].abs().max()))
    assert not torch.allclose(alone[0], make_decode_step(
        mcfg, scfg, batch=1)(params, make_precompute_step(
            mcfg, scfg, fold_gsb=True)(params, tenants[1]),
        tlm.init_cache(mcfg, 1, 8) | {"len": 3},
        {"tokens": tokens[:1]})[0])
    dynamic = []
    for m in (mesh, None):
        pre = make_precompute_step(mcfg, scfg, m, fold_gsb=True)
        stacked = tadapter.stack_adapter_states(
            [pre(params, ad) for ad in tenants], axis=1)
        cache = tlm.init_cache(mcfg, 2, 8, mesh=m)
        cache["len"] = 3
        logits, new = make_decode_step(mcfg, scfg, m, batch=2,
                                       dynamic_groups=True)(
            params, stacked, cache, {"tokens": tokens,
                                     "adapter_idx": [1, 0]})
        dynamic.append((logits, new["stack"]["l0"]["k"]))
    for got, want in zip(*dynamic):
        assert torch.equal(got, want)
    with pytest.raises(NotImplementedError,
                       match="item 6, second half, point 2"):
        make_decode_step(get_config("falcon-mamba-7b", smoke=True), scfg,
                         mesh, batch=2)
    out = []
    for m in (mesh, None):
        paged = tlm.init_cache(mcfg, 2, 8, row_lens=True, block_size=4,
                               mesh=m)
        paged["pages"] = torch.tensor([[0, -1], [2, -1]], dtype=torch.int32)
        paged["len"] = torch.tensor([1, 3], dtype=torch.int32)
        logits, new = make_decode_step(mcfg, scfg, m, batch=2)(
            params, {}, paged, {"tokens": tokens})
        out.append((logits, new["len"], new["stack"]["l0"]["k"]))
    for got, want in zip(*out):
        assert torch.equal(got, want)


class _ReplicaMesh:
    """A (data, model) mesh seen from the rank at data index ``i``: what
    ``local_rows`` reads, with no process group."""

    def __init__(self, data: int, i: int, model: int = 1):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}
        self.coords = {"data": i, "model": 0}

    def axis_index(self, axes) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def _whole_groups(sizes):
    starts = np.cumsum([0] + list(sizes[:-1]))
    return tuple((int(s), int(n)) for s, n in zip(starts, sizes))


_LOCALIZER_CASES = [
    # batch 6 at data 2: tenant 1's group straddles the replica boundary,
    # tenants 0 and 2 each on one replica only.
    (2, (2, 2, 2)),
    (2, (1, 4, 1)), (2, (3, 3)), (2, (5, 1)), (2, (1, 1, 1, 1, 1, 1)),
    (2, (8,)), (4, (2, 3, 3)), (4, (1, 6, 1)), (4, (7, 1)),
    (4, (1, 1, 5, 1)), (2, (2, 6, 2)), (4, (3, 5, 2, 2)),
    # a batch the data axis does not split: every replica holds it all
    (4, (1, 2, 3)), (4, (2, 3)), (2, (3,)), (4, (5, 2, 2)),
]


@pytest.mark.parametrize("data,sizes", _LOCALIZER_CASES, ids=str)
def test_local_tenant_groups_tile_each_replica_and_concatenate_back(
        data, sizes):
    """``local_tenant_groups`` cuts the whole batch's static groups to
    each data replica's rows (``local_rows``): each replica's triples tile
    its rows in order with stack positions in range (a group reaching no
    row of it dropped, one that straddles two kept on both), and the
    replicas' groups, rebased and concatenated, give back the whole-batch
    groups. Where ``_dp_entry`` replicates the batch the groups pass
    through unchanged; where the axis holds one rank too."""
    from repro_torch.core.adapter import tenant_positions

    whole = _whole_groups(sizes)
    batch = sum(sizes)
    split = batch % data == 0
    rows = {}
    for i in range(data):
        mesh = _ReplicaMesh(data, i)
        mine = TS.local_rows(mesh, batch)
        local = TS.local_tenant_groups(mesh, batch, whole)
        if not split:
            assert local == whole and (mine.start, mine.stop) == (0, batch)
            continue
        assert tenant_positions(local, mine.stop - mine.start,
                                len(whole)) == local
        for s, n, k in local:
            for r in range(mine.start + s, mine.start + s + n):
                rows.setdefault(k, []).append(r)
    if split:
        back = tuple((min(r), len(r)) for _, r in sorted(rows.items()))
        assert back == whole
        for k, r in rows.items():
            assert r == list(range(whole[k][0], sum(whole[k])))
    assert TS.local_tenant_groups(_ReplicaMesh(1, 0), batch, whole) == whole


def test_local_tenant_groups_names_the_straddling_case():
    """Batch 6 at data 2 (the mesh serving tests' layout): tenant 1's
    group crosses the replica boundary, tenant 0 is on replica 0 only
    and tenant 2 on replica 1 only; the grouped compose takes the local
    triples and refuses a position outside the stack."""
    groups = ((0, 2), (2, 2), (4, 2))
    assert TS.local_tenant_groups(_ReplicaMesh(2, 0), 6, groups) == (
        (0, 2, 0), (2, 1, 1))
    assert TS.local_tenant_groups(_ReplicaMesh(2, 1), 6, groups) == (
        (0, 1, 1), (1, 2, 2))
    W = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    st = {"A": torch.ones(3, 2, 4), "g": torch.ones(3, 8),
          "gsB": torch.zeros(3, 8, 2)}
    x = torch.randn(3, 1, 4, generator=torch.Generator().manual_seed(1))
    y = tadapter.dora_linear_grouped(x, W, st, None, ((0, 1, 1), (1, 2, 2)))
    assert torch.equal(y, x @ W.T)
    for bad, match in [(((0, 1, 3), (1, 2, 2)), "outside the K=3"),
                       (((0, 1, 1), (1, 2)), "mix"),
                       (((0, 1, 1), (2, 1, 2)), "contiguously")]:
        with pytest.raises(ValueError, match=match):
            tadapter.dora_linear_grouped(x, W, st, None, bad)


# ---------------------------------------------------------------------------
# Dynamic grouping and speculation on a mesh.
# ---------------------------------------------------------------------------

def _tiny_serving(n_tenants: int = 3):
    """A 1-layer fp32 model, its params and ``n_tenants`` perturbed
    adapter trees (torch, from one generator)."""
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import ModelConfig

    mcfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=64,
                       num_heads=2, num_kv_heads=1, d_ff=128,
                       vocab_size=64, dtype=torch.float32)
    scfg = StepConfig(dora=DoRAConfig(rank=4, alpha=8.0))
    gen = torch.Generator().manual_seed(0)
    params = tlm.init_params(gen, mcfg)
    tenants = []
    for _ in range(n_tenants):
        ad = tlm.init_adapters(gen, mcfg, params, scfg.dora)
        for name, leaf in flatten_paths(ad).items():
            if name.endswith("/B"):
                leaf.copy_(0.05 * torch.randn(leaf.shape, generator=gen))
        tenants.append(ad)
    return mcfg, scfg, params, tenants


@pytest.mark.parametrize("paged", [False, True], ids=["rect", "paged"])
@pytest.mark.parametrize("kind", ["decode", "draft", "verify"])
def test_one_rank_mesh_dynamic_draft_and_verify_steps_equal_no_mesh(kind,
                                                                    paged):
    """On a one-rank gloo mesh the engine's dynamic decode step, its
    draft step and its dynamic verify step (a window of 3) over the
    engine's per-row cache, rectangular and paged (an out-of-order block
    table), give the no-mesh steps' logits, lengths and K/V bit for bit;
    the verify returns every window position's logits."""
    from repro_torch.launch.steps import (make_decode_step, make_draft_step,
                                          make_precompute_step,
                                          make_verify_step)

    mcfg, scfg, params, tenants = _tiny_serving()
    mesh = tmesh.make_debug_mesh(1, 1, device="cpu", backend="gloo")
    idx = torch.tensor([2, 0, 2, 1])
    window = 3 if kind == "verify" else 1
    toks = torch.arange(4 * window).reshape(4, window) * 5 % 64
    out = []
    for m in (mesh, None):
        pre = make_precompute_step(mcfg, scfg, m, fold_gsb=True)
        stacked = tadapter.stack_adapter_states(
            [pre(params, ad) for ad in tenants], axis=1)
        geo = dict(block_size=4, n_blocks=16) if paged else {}
        cache = tlm.init_cache(mcfg, 4, 16, row_lens=True, mesh=m, **geo)
        if paged:
            cache["pages"] = torch.tensor(
                [[3, 7, 0, -1], [12, 1, -1, -1], [5, -1, -1, -1],
                 [9, 2, 14, -1]], dtype=torch.int32)
        cache["len"] = torch.tensor([3, 5, 1, 7], dtype=torch.int32)
        batch_in = {"tokens": toks, "adapter_idx": idx}
        if kind == "decode":
            logits, new = make_decode_step(mcfg, scfg, m, batch=4,
                                           dynamic_groups=True)(
                params, stacked, cache, batch_in)
        elif kind == "draft":
            logits, new = make_draft_step(mcfg, scfg, m, batch=4)(
                params, cache, batch_in)
        else:
            logits, new = make_verify_step(mcfg, scfg, m, batch=4,
                                           window=3, dynamic_groups=True)(
                params, stacked, cache, batch_in)
        out.append((logits, new["len"], new["stack"]["l0"]["k"],
                    new["stack"]["l0"]["v"]))
    assert out[0][0].shape == ((4, 3, 64) if kind == "verify" else (4, 64))
    assert out[0][1].tolist() == [3 + window, 5 + window, 1 + window,
                                  7 + window]
    for got, want in zip(*out):
        assert torch.equal(got, want)


@pytest.mark.parametrize("window", [2, 4])
def test_decode_layout_takes_the_verify_window(window):
    """The decode layout (``make_boundary_constraint(decode=True)``) takes
    S = k + 1: the spec leaves the sequence whole where the
    sequence-parallel one would split it over model, the residual stream
    is whole on every rank (gather and local rows the identity), the
    vocab-parallel lookup's scatter keeps [B, S, D], and ``mesh_layout``
    builds the verify's layout on the meshes it accepts."""
    from repro_torch.launch.steps import StepConfig, mesh_layout

    mesh = FakeMesh(data=2, model=2)
    sp = TS.make_boundary_constraint(mesh, batch=4, seq=window,
                                     decode=True)
    assert not sp.seq_split and sp.prefix == "tp"
    assert tuple(sp.spec) == ("data", None, None)
    assert tuple(TS.make_boundary_constraint(mesh, batch=4,
                                             seq=window).spec) == (
        "data", "model", None)
    x = torch.ones(2, window, 8)
    assert sp.gather(x) is x and sp.local_rows(x) is x
    small = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    lay = mesh_layout(small, StepConfig(dora=DoRAConfig(rank=16,
                                                         alpha=32.0)),
                      mesh, batch=4, seq=window, decode=True)
    assert lay.local_batch == 2 and not lay.sp.seq_split


class _TwoModelRanks:
    """A (data 1, model 2) mesh seen from model rank 0, in one process:
    ``group`` names a group for the model axis, and the test replaces
    ``all_reduce`` by the identity, so each collective runs and is
    counted (its bytes) without a second rank."""

    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}

    def group(self, axes):
        return "model" if "model" in axes else None

    def axis_size(self, axes):
        return 2 if "model" in axes else 1

    def axis_index(self, axes):
        return 0


@pytest.mark.parametrize("K", [2, 5])
def test_row_parallel_dynamic_compose_all_reduces_one_rank_space_row(
        K, monkeypatch):
    """The row-parallel dynamic compose under the decode layout at model
    = 2 selects each row's stack position BEFORE its one all-reduce of h:
    it moves [B, S, r] fp32, as a single-tenant call does, not the
    [B, S, K, r] of all K partials, and y_base's bytes are the single
    call's too (``collective_stats`` by tag)."""
    monkeypatch.setattr(tsh.dist, "all_reduce",
                        lambda t, op=None, group=None: None)
    mesh = _TwoModelRanks()
    sp = TS.make_boundary_constraint(mesh, batch=3, seq=2, decode=True)
    B, S, d_in_l, d_out, r = 3, 2, 16, 24, 4
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, d_in_l, generator=gen)
    W = torch.randn(d_out, d_in_l, generator=gen)
    stack = {"A": torch.randn(K, r, d_in_l, generator=gen),
             "g": 1 + 0.1 * torch.randn(K, d_out, generator=gen),
             "gsB": torch.randn(K, d_out, r, generator=gen)}
    stats = {}
    for label, adapter, groups in (
            ("dynamic", stack, torch.tensor([K - 1, 0, K - 1])),
            ("single", {**{k: v[0] for k, v in stack.items()},
                        "B": torch.zeros(d_out, r), "m": torch.ones(d_out)},
             None)):
        tsh.reset_collective_stats()
        y = tadapter.dora_linear_row_parallel(
            x, W, adapter, DoRAConfig(rank=r, alpha=8.0), sp=sp,
            training=False, tenant_groups=groups)
        assert y.shape == (B, S, d_out)
        stats[label] = tsh.collective_stats()
    assert stats["dynamic"] == stats["single"]
    assert stats["dynamic"]["tp.h"] == {"calls": 1, "bytes": B * S * r * 4}
    assert stats["dynamic"]["tp.y_base"]["bytes"] == B * S * d_out * 4
