"""Rank programs of ``tests/test_torch_dist.py``: the port on gloo CPU
ranks. This module imports no ``jax`` and nothing of the reference: the
reference's results are computed in the test process, and the ranks get
numpy copies of the inputs through the spawn.

:class:`Ranks` starts ``world`` ranks (``torch.multiprocessing``,
spawn, a ``file://`` store) that run every case of one world size in
order; its ``join`` waits under a timeout of its own (a hung collective
kills the group and fails the one test) and returns rank 0's results.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


class Ranks:
    """``world`` gloo ranks running ``cases`` ([(name, function name in
    this module, payload)]) in order, started at construction: the caller
    may compute while they run, then :meth:`join` them."""

    def __init__(self, world: int, cases: list, workdir,
                 timeout: float = TIMEOUT_S):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.world = world
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.ctx = mp.start_processes(_rank_main,
                                      args=(world, str(self.workdir), cases),
                                      nprocs=world, join=False,
                                      start_method="spawn")

    def join(self) -> dict:
        """{name: rank 0's result}; a rank that raised fails here, and
        ranks still running at the deadline are killed."""
        try:
            while not self.ctx.join(timeout=1):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.world} ranks did not finish "
                                       f"in {self.timeout} s")
        finally:
            self.kill()
        return pickle.loads((self.workdir / "rank0.pkl").read_bytes())

    def kill(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _rank_main(rank: int, world: int, workdir: str, cases: list):
    torch.set_num_threads(1)
    os.environ.pop("REPRO_TORCH_FORCE_TIER", None)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    try:
        out = {name: globals()[fn](payload) for name, fn, payload in cases}
        (Path(workdir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(*shape, device="cpu", backend="gloo")


def _np(t):
    return t.detach().cpu().numpy()


def _cut(x, dim, axes, mesh):
    """This rank's slice of ``x`` along ``dim`` over ``axes``."""
    n = mesh.axis_size(axes) if axes else 1
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * step, step) if axes else x


# --- the sharded norm -------------------------------------------------------

def norm_case(p):
    """factored_norm_sharded with W and A cut along d_in over p["axes"]:
    s != 0 and s = 0, with and without the summed base term, on the
    kernel wrappers (their plain versions here) and the eager terms."""
    from repro_torch.core import sharding as csh
    from repro_torch.core.factored_norm import factored_norm_sharded

    mesh = _mesh(p["shape"])
    axes = p["axes"]
    W, A, B = (torch.from_numpy(p[k].copy()) for k in ("W", "A", "B"))
    Wl, Al = _cut(W, 1, axes, mesh), _cut(A, 1, axes, mesh)
    base_sq = torch.from_numpy(p["base_sq"].copy())
    out = {}
    for kernels in (True, False):
        for s in (p["s"], 0.0):
            for cache in (None, base_sq):
                csh.reset_collective_stats()
                w = factored_norm_sharded(Wl, Al, B, s, axis_name=axes,
                                          mesh=mesh, base_sq_cache=cache,
                                          kernels=kernels)
                key = (kernels, s != 0.0, cache is not None)
                out[key] = (_np(w), csh.collective_stats().get(
                    "norm", {"calls": 0, "bytes": 0}))
    return out


# --- the shard-local compose ------------------------------------------------

def compose_case(p):
    """fused_compose_mm under a 2-D plan (p["spec"] over [M, N]) on each
    rank's tiles; delta and the gradients of (base, h, B, g) for dY,
    gathered back to whole tensors."""
    from repro_torch.core import sharding as csh
    from repro_torch.kernels import ops

    mesh = _mesh(p["shape"])
    plan = csh.plan_for_output(mesh, p["spec"])
    row_axes, dout_axes = plan.row_axes, plan.dout_axes
    base, h, B, g, dy = (torch.from_numpy(p[k].copy())
                         for k in ("base", "h", "B", "g", "dy"))

    def tile(x):
        return _cut(_cut(x, 0, row_axes, mesh), 1, dout_axes, mesh)

    bl = tile(base).requires_grad_(True)
    hl = _cut(h, 0, row_axes, mesh).requires_grad_(True)
    Bl = _cut(B, 0, dout_axes, mesh).requires_grad_(True)
    gl = _cut(g, 0, dout_axes, mesh).requires_grad_(True)
    csh.reset_collective_stats()
    delta = ops.fused_compose_mm(bl, hl, Bl, gl, p["s"], sharding=plan)
    fwd_calls = sum(v["calls"] for v in csh.collective_stats().values())
    delta.backward(tile(dy))

    def whole(x, rows, cols):
        if rows:
            x = csh.all_gather(x.contiguous(), rows, mesh, 0)
        if cols:
            x = csh.all_gather(x.contiguous(), cols, mesh, 1)
        return _np(x)

    stats = csh.collective_stats()
    return {"delta": whole(delta, row_axes, dout_axes),
            "d_base": whole(bl.grad, row_axes, dout_axes),
            "d_h": whole(hl.grad, row_axes, ()),
            "d_B": whole(Bl.grad, dout_axes, ()),
            "d_g": _np(csh.all_gather(gl.grad, dout_axes, mesh, 0)),
            "fwd_collectives": fwd_calls, "collectives": stats}


# --- the train and prefill steps ---------------------------------------------

def _model(p):
    from repro_torch.core.config import DoRAConfig
    from repro_torch.models.config import ModelConfig

    return (ModelConfig(**p["widths"], dtype=torch.float32),
            DoRAConfig(**p["dora"]))


def _shards(p, mesh, mcfg, dcfg):
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.launch import sharding as S

    params = S.shard_tree(tree_from_numpy(p["params"]),
                          S.param_sharding(mcfg, mesh), mesh)
    aspec = S.adapter_sharding(mcfg, dcfg, mesh)
    adapters = S.shard_tree(tree_from_numpy(p["adapters"]), aspec, mesh)
    return params, adapters, aspec


@contextlib.contextmanager
def _counting_plain_calls():
    """{plain version: calls} while the block runs: the kernel wrappers
    run their plain versions on CPU tensors, once a launch."""
    from repro_torch.kernels import (dora_compose, factored_norm,
                                     norm_assembly, paged_gather)

    calls: dict = {}
    saved = []
    for mod in (factored_norm, norm_assembly, dora_compose, paged_gather):
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.endswith("_plain") and not name.startswith("_"):
                def counted(*a, _fn=fn, _name=name, **k):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*a, **k)
                saved.append((mod, name, fn))
                setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_case(p):
    """One make_grad_step on the mesh (loss, gradients gathered, the
    collectives' bytes) and one make_train_step from the same shards
    (loss, grad norm, lr)."""
    from repro_torch.core import sharding as csh
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import (StepConfig, make_grad_step,
                                          make_train_step)
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.tree import flatten_paths

    mesh = _mesh(p["shape"])
    mcfg, dcfg = _model(p)
    scfg = StepConfig(dora=dcfg, optim=OptimizerConfig(**p["optim"]),
                      loss_tokens=p["loss_tokens"])
    batch, seq = p["tokens"].shape
    bspec = S.batch_spec(mesh, batch=batch)
    bt = S.shard_tree({"tokens": torch.from_numpy(p["tokens"].copy()),
                       "labels": torch.from_numpy(p["labels"].copy())},
                      {"tokens": bspec, "labels": bspec}, mesh)
    params, adapters, aspec = _shards(p, mesh, mcfg, dcfg)
    csh.reset_collective_stats()
    with _counting_plain_calls() as calls:
        loss, grads = make_grad_step(mcfg, scfg, mesh, batch=batch,
                                     seq=seq)(params, adapters, bt)
    stats = csh.collective_stats()
    full = S.unshard_tree(grads, aspec, mesh)
    step = make_train_step(mcfg, scfg, mesh, batch=batch, seq=seq)
    _, _, met = step(params, adapters, adamw_init(adapters), bt)
    return {"loss": float(loss), "plain_calls": calls,
            "grads": {k: _np(v) for k, v in flatten_paths(full).items()},
            "collectives": stats, "step_loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), "lr": met["lr"]}


def prefill_case(p):
    """make_prefill_step on the mesh: the last logits (gathered over the
    vocab) and layer 0's cached K of this rank's heads and rows."""
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import StepConfig, make_prefill_step

    mesh = _mesh(p["shape"])
    mcfg, dcfg = _model(p)
    batch, seq = p["batch"], p["seq"]
    bspec = S.batch_spec(mesh, batch=batch)
    toks = S.shard_tree({"tokens": torch.from_numpy(p["tokens"].copy())},
                        {"tokens": bspec}, mesh)
    params, adapters, _ = _shards(p, mesh, mcfg, dcfg)
    logits, cache = make_prefill_step(mcfg, StepConfig(dora=dcfg), mesh,
                                      batch=batch, seq=seq)(
        params, adapters, toks)
    from repro_torch.core import sharding as csh
    rows = csh._entry_axes(bspec[0])
    return {"logits": _np(csh.all_gather(logits, rows, mesh, 0)),
            "k0": _np(cache["stack"]["l0"]["k"]), "len": cache["len"],
            "coords": dict(mesh.coords)}


def roundtrip_case(p):
    """shard_tree then unshard_tree gives back the tree, bit for bit."""
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.launch import sharding as S
    from repro_torch.tree import flatten_paths

    mesh = _mesh(p["shape"])
    mcfg, dcfg = _model(p)
    full = tree_from_numpy(p["params"])
    spec = S.param_sharding(mcfg, mesh)
    back = S.unshard_tree(S.shard_tree(full, spec, mesh), spec, mesh)
    return all(np.array_equal(_np(a), _np(b)) for a, b in zip(
        flatten_paths(full).values(), flatten_paths(back).values()))


def compression_case(p):
    """cross_pod_sync on a (pod=2, data=2) mesh: each rank's toy gradient
    of examples/grad_compression_dp.py from its quarter of x, synced fp32
    over data and int8 with error feedback over pod, twice."""
    from repro_torch.core import sharding as csh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compression as C

    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu", backend="gloo")
    x, w, t = (torch.from_numpy(p[k].copy()) for k in ("x", "w", "t"))
    rows = x.shape[0] // mesh.size
    r = mesh.axis_index(("pod", "data"))
    g = {"g": x[r * rows:(r + 1) * rows].mean(dim=0) * (w - t)}
    csh.reset_collective_stats()
    synced, ef = C.cross_pod_sync(g, mesh)
    stats = csh.collective_stats()
    again, ef2 = C.cross_pod_sync(g, mesh, ef)
    return {"synced": _np(synced["g"]), "ef": _np(ef["g"]),
            "again": _np(again["g"]), "ef2": _np(ef2["g"]),
            "stats": stats}


def placements_case(p):
    """The (host, card) pairs that ``make_mesh`` gathers under NCCL, here
    over the gloo ranks: every rank naming card 0 (as ranks that never
    called ``set_device`` would) is refused; one card a rank passes."""
    from repro_torch.launch import mesh as M

    shared = M._placements(torch.device("cuda", 0))
    own = M._placements(torch.device("cuda", dist.get_rank()))
    refused = None
    try:
        M.check_backend("nccl", torch.device("cuda", 0), shared)
    except ValueError as e:
        refused = str(e)
    M.check_backend("nccl", torch.device("cuda", 0), own)
    return {"shared": shared, "own": own, "refused": refused}


# --- single-tenant serving across the mesh -----------------------------------

class _DuckMesh:
    """``axis_names`` and ``shape`` of a mesh no process group backs."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _gather_spec(x, spec, mesh):
    from repro_torch.launch import sharding as S
    return S.unshard_tree({"x": x}, {"x": spec}, mesh)["x"]


def serve_case(p):
    """The serving path on the mesh: (a) the mesh precompute's g and gsB,
    folded and not, gathered; (b) greedy generate(mesh=) with its per-step
    logits, the kernel wrappers' plain calls it made, the tokens the same
    on every rank, and the K/V after the padded prefill and after the last
    decode step (the steps run again on the same tokens), gathered over
    the data rows and the heads; (c) temperature sampling against the
    port's single-card generate on the whole trees; (d) the same prompts
    through a handle of AdapterStateCache.for_serving(mesh=), and a cache
    keyed for another mesh refused."""
    import torch.nn.functional as F

    from repro_torch.bridge import tree_from_numpy
    from repro_torch.core import sharding as csh
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import (StepConfig, make_decode_step,
                                          make_precompute_step,
                                          make_prefill_step)
    from repro_torch.tree import flatten_paths

    mesh = _mesh(p["shape"])
    mcfg, dcfg = _model(p)
    scfg = StepConfig(dora=dcfg)
    params, adapters, _ = _shards(p, mesh, mcfg, dcfg)
    serving = flatten_paths(S.adapter_sharding(mcfg, dcfg, mesh,
                                               serving=True))
    prompts, G, L = p["prompts"], p["gen_len"], p["max_len"]
    B, P = prompts.shape
    out = {"state": {}}
    for fold in (True, False):
        st = make_precompute_step(mcfg, scfg, mesh, fold_gsb=fold)(
            params, adapters)
        out["state"][fold] = {
            name: _np(_gather_spec(leaf, serving[name], mesh))
            for name, leaf in flatten_paths(st).items()
            if name.rsplit("/", 1)[1] in ("g", "gsB")}
    kw = dict(gen_len=G, max_len=L, mesh=mesh)
    with _counting_plain_calls() as calls:
        toks, logits = serve.generate(mcfg, params, adapters, scfg, prompts,
                                      return_logits=True, **kw)
    out["plain_calls"] = dict(calls)
    out["tokens"], out["logits"] = _np(toks), [_np(x) for x in logits]
    every = ("data", "model")
    out["same_on_every_rank"] = bool(torch.equal(
        csh.pmax(toks, every, mesh), -csh.pmax(-toks, every, mesh)))

    state = make_precompute_step(mcfg, scfg, mesh)(params, adapters)
    prefill = make_prefill_step(mcfg, scfg, mesh, batch=B, seq=L,
                                padded=True)
    rows = serve._Rows(prefill.layout)
    dp = csh.P(None, S.batch_spec(mesh, batch=B)[0], None, "model", None)

    def kv(cache):
        return {f"{li}/{n}": _np(_gather_spec(t, dp, mesh))
                for li, layer in cache["stack"].items()
                for n, t in layer.items()}

    _, cache = prefill(params, state, {
        "tokens": F.pad(rows.local(toks[:, :P]), (0, L - P)),
        "prompt_len": P})
    out["kv_prefill"] = kv(cache)
    decode = make_decode_step(mcfg, scfg, mesh, batch=B)
    for t in range(G):
        _, cache = decode(params, state, cache,
                          {"tokens": rows.local(toks[:, P + t:P + t + 1])})
    out["kv_last"], out["len"] = kv(cache), cache["len"]

    hot = dict(temperature=p["temperature"], seed=p["seed"])
    out["sampled"] = _np(serve.generate(mcfg, params, adapters, scfg,
                                        prompts, **kw, **hot))
    out["sampled_single"] = _np(serve.generate(
        mcfg, tree_from_numpy(p["params"]), tree_from_numpy(p["adapters"]),
        scfg, prompts, gen_len=G, max_len=L, device="cpu", **hot))

    cache_s = AdapterStateCache.for_serving(mcfg, scfg, mesh=mesh)
    handle = cache_s.register("tenant", adapters)
    out["handle_tokens"] = _np(serve.generate(
        mcfg, params, handle, scfg, prompts, adapter_cache=cache_s, **kw))
    out["cache_key"] = cache_s.make_key(handle).sharding
    d, t = p["shape"]
    d, t = (t, d) if d != t else (d * t, 1)
    other = AdapterStateCache.for_serving(
        mcfg, scfg, mesh=_DuckMesh(data=d, model=t), device="cpu")
    other.register("tenant", adapters)
    try:
        serve.generate(mcfg, params, other.current_handle("tenant"), scfg,
                       prompts, adapter_cache=other, **kw)
        out["other_mesh_refused"] = None
    except ValueError as e:
        out["other_mesh_refused"] = str(e)
    if "tenants" in p:
        out["mt"] = _multitenant(p, mesh, mcfg, scfg, params)
    return out


def _tenant_cache(p, mesh, mcfg, scfg, aspec, tenants=None):
    """AdapterStateCache.for_serving(mesh=) with ``tenants`` (default
    p["tenants"]) registered as t0, t1, ... (this rank's shards of
    each)."""
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.launch import sharding as S

    cache = AdapterStateCache.for_serving(mcfg, scfg, mesh=mesh)
    for t, ad in enumerate(p["tenants"] if tenants is None else tenants):
        cache.register(f"t{t}", S.shard_tree(tree_from_numpy(ad), aspec,
                                             mesh))
    return cache


def _multitenant(p, mesh, mcfg, scfg, params):
    """MultiTenantServer(mesh=) over three tenants: its tokens and
    per-step logits cold, its tokens warm, the cache's stats and whether
    every rank's equal this one's, a max_len the model axis does not
    split refused (or served where it has one rank); each local group's delta of layer 0's
    wq (column-parallel) and wo (row-parallel), under the decode and the
    sequence-parallel layouts, against the homogeneous mesh path's on
    the same rows (bitwise, for groups of two or more rows), and the
    whole module within 1e-6 of max of that path alone; the collective
    calls and bytes of a grouped decode step against a single-tenant one
    at the same batch."""
    from repro_torch.core import adapter as A
    from repro_torch.core import sharding as csh
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.lm import init_cache

    aspec = S.adapter_sharding(mcfg, scfg.dora, mesh)
    cache = _tenant_cache(p, mesh, mcfg, scfg, aspec)
    server = serve.MultiTenantServer(mcfg, scfg, params, cache=cache,
                                     mesh=mesh)
    reqs = [serve.Request(q, f"t{t}")
            for q, t in zip(p["mt_prompts"], p["mt_owners"])]
    kw = dict(gen_len=p["gen_len"], max_len=p["max_len"])
    toks, logits = server.serve(reqs, return_logits=True, **kw)
    warm = server.serve(reqs, **kw)
    out = {"tokens": _np(toks), "logits": [_np(x) for x in logits],
           "warm_tokens": _np(warm),
           "cache": cache.stats().as_dict(),
           "groups": list(server._steps)[-1][3]}
    out["same_on_every_rank"] = _same_on_every_rank(
        (out["tokens"].tolist(), out["cache"]))
    try:
        server.serve(reqs, gen_len=p["gen_len"], max_len=p["max_len"] + 1)
        out["odd_max_len_refused"] = None
    except ValueError as e:
        out["odd_max_len_refused"] = str(e)

    handles = [cache.current_handle(f"t{t}") for t in range(3)]
    states = [cache.get_state(params, h, allow_miss=False) for h in handles]
    stacked = A.stack_adapter_states(states, axis=1)
    B = len(reqs)
    groups = tuple((2 * t, 2) for t in range(3))
    gen = torch.Generator().manual_seed(5)
    bits, close = [], []
    for decode in (True, False):
        seq = 1 if decode else p["max_len"]
        sp = S.make_boundary_constraint(mesh, batch=B, seq=seq,
                                        decode=decode)
        local = S.local_tenant_groups(mesh, B, groups)
        mine = S.local_rows(mesh, B)
        rows = mine.stop - mine.start
        positions = A.tenant_positions(local, rows, len(groups))
        for name, col in (("wq", True), ("wo", False)):
            W = params["stack"]["l0"]["mixer"][name][0]
            leaf = {k: v[0] for k, v in
                    stacked["stack"]["l0"]["mixer"][name].items()}
            per = [{k: v[0] for k, v in
                    st["stack"]["l0"]["mixer"][name].items()}
                   for st in states]
            x = torch.randn(rows, seq, W.shape[1], generator=gen)
            if col:
                y = A.dora_linear_column_parallel(
                    x, W, leaf, scfg.dora, sp=sp, training=False,
                    tenant_groups=local)
                y_base = x @ W.T
            else:
                y = A.dora_linear_row_parallel(
                    x, W, leaf, scfg.dora, sp=sp, training=False,
                    tenant_groups=local)
                y_base = sp.scatter(sp.partial(x, W), tag="y_base")
            for s, n, k in positions:
                xs = x[s:s + n]
                if col:
                    h = xs @ per[k]["A"].T
                    alone = A.dora_linear_column_parallel(
                        xs, W, per[k], scfg.dora, sp=sp, training=False)
                else:
                    h = sp.scatter(sp.partial(xs, per[k]["A"]),
                                   tag="h").to(x.dtype)
                    alone = A.dora_linear_row_parallel(
                        xs, W, per[k], scfg.dora, sp=sp, training=False)
                yb = y_base[s:s + n]
                want = yb + A.gsb_delta(yb, h, per[k]["g"], per[k]["gsB"])
                if n >= 2:
                    bits.append(bool(torch.equal(y[s:s + n], want)))
                close.append(float((y[s:s + n] - alone).abs().max()
                                   / alone.abs().max()))
    out["delta_bitwise"] = bits
    out["module_rel"] = close

    stats = {}
    for label, tree, tg in (("grouped", stacked, groups),
                            ("single", states[0], None)):
        c = init_cache(mcfg, B, p["max_len"], mesh=mesh)
        c["len"] = p["prompt_len"]
        step = make_decode_step(mcfg, scfg, mesh, batch=B, tenant_groups=tg)
        mine = S.local_rows(mesh, B)
        tok = torch.as_tensor(p["mt_prompts"][:, :1])[mine]
        csh.reset_collective_stats()
        step(params, tree, c, {"tokens": tok})
        stats[label] = csh.collective_stats()
    out["decode_collectives"] = stats
    return out


# --- the continuous-batching engine across the mesh --------------------------

def _drive(engine, trace, prompts, **submit_kw):
    """Submit each (arrival step, P, new tokens) request as its arrival
    step comes due and tick once per step (``tests/test_torch_engine.py
    _drive``); returns {request_id: [token, ...]} as on_token streamed
    them."""
    streams: dict = {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(int(tok))

    i, step = 0, 0
    while i < len(trace) or engine.has_work():
        while i < len(trace) and trace[i][0] <= step:
            kw = {k: v[i] for k, v in submit_kw.items()}
            engine.submit(prompts[i], max_new_tokens=trace[i][2], key_id=i,
                          **kw)
            i += 1
        engine.step(on_token)
        step += 1
    return streams


def _same_on_every_rank(obj) -> bool:
    """Whether every rank of the world holds an ``obj`` equal to this
    rank's."""
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return all(o == obj for o in every)


def engine_case(p):
    """DecodeEngine(mesh=) on the committed traces, each with a fixed
    serving tree from the mesh precompute (g cached, B unfolded, as
    generate serves) and with a one-handle cache of
    AdapterStateCache.for_serving(mesh=) (gsB folded): streams, stats,
    pool stats, device steps and the plain gathers (K8's calls) a rank;
    the priority and deadline trace's results; EngineServer(mesh=).run's
    results; and whether every rank returned what this one did."""
    from repro_torch.core.adapter_cache import AdapterStateCache
    from repro_torch.launch import serve
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import StepConfig, make_precompute_step

    mesh = _mesh(p["shape"])
    mcfg, dcfg = _model(p)
    scfg = StepConfig(dora=dcfg)
    params, adapters, _ = _shards(p, mesh, mcfg, dcfg)
    state = make_precompute_step(mcfg, scfg, mesh)(params, adapters)

    def cache():
        c = AdapterStateCache.for_serving(mcfg, scfg, mesh=mesh)
        c.register("t0", adapters)
        return c

    out = {}
    for name, (trace, prompts, kw, submit) in p["traces"].items():
        for route in ("fixed", "cache"):
            if route == "fixed":
                eng = DecodeEngine(mcfg, scfg, params, adapters=state,
                                   mesh=mesh, **kw)
                sub = submit
            else:
                eng = DecodeEngine(mcfg, scfg, params, adapter_cache=cache(),
                                   mesh=mesh, **kw)
                sub = {**submit, "adapter": ["t0"] * len(trace)}
            with _counting_plain_calls() as calls:
                streams = _drive(eng, trace, prompts, **sub)
            rec = {"streams": streams, "stats": eng.stats().as_dict(),
                   "device_steps": eng.device_steps(),
                   "results": [(r.request_id, r.tokens.tolist(),
                                r.finish_reason, r.admitted_step,
                                r.finished_step, r.preempted)
                               for r in eng.pop_results()],
                   "gathers": calls.get("paged_gather_plain", 0),
                   "pool": eng.pool_stats() if kw.get("paged") else None}
            rec["same_on_every_rank"] = _same_on_every_rank(rec)
            out[f"{name}_{route}"] = rec
    prompts, kw, gen = p["server"]
    server = serve.EngineServer(mcfg, scfg, params, cache=cache(),
                                mesh=mesh, **kw)
    res = server.run([serve.Request(q, "t0") for q in prompts],
                     gen_len=gen)
    rec = {"tokens": [r.tokens.tolist() for r in res],
           "reasons": [r.finish_reason for r in res],
           "stats": server.engine.stats().as_dict(),
           "pool": server.engine.pool_stats()}
    rec["same_on_every_rank"] = _same_on_every_rank(rec)
    out["server"] = rec
    if "tenants" in p:
        out.update(_engine_tenants(p, mesh, mcfg, scfg, params))
    if "fleet" in p:
        out.update(_engine_fleet(p, mesh, mcfg, scfg, params))
        out.update(_engine_speculative(p, mesh, mcfg, scfg, params,
                                       adapters))
    return out


def _engine_tenants(p, mesh, mcfg, scfg, params):
    """The cache-routed DecodeEngine(mesh=) on p["mt_traces"] with the
    requests spread over three handles (static slot layouts of two or
    more handles), rectangular and paged, and EngineServer(mesh=).run of
    p["mt_server"]: streams, results, stats, the cache's stats, the
    decode signatures, the plain gathers, and whether every rank's equal
    this one's."""
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    from repro_torch.launch.engine import DecodeEngine

    aspec = S.adapter_sharding(mcfg, scfg.dora, mesh)
    out = {}
    for name, (trace, prompts, kw, owners) in p["mt_traces"].items():
        cache = _tenant_cache(p, mesh, mcfg, scfg, aspec)
        eng = DecodeEngine(mcfg, scfg, params, adapter_cache=cache,
                           mesh=mesh, **kw)
        with _counting_plain_calls() as calls:
            streams = _drive(eng, trace, prompts, adapter=owners)
        rec = {"streams": streams, "stats": eng.stats().as_dict(),
               "results": [(r.request_id, r.tokens.tolist(),
                            r.finish_reason) for r in eng.pop_results()],
               "device_steps": eng.device_steps(),
               "signatures": eng.step_signatures(),
               "cache": cache.stats().as_dict(),
               "gathers": calls.get("paged_gather_plain", 0),
               "pool": eng.pool_stats() if kw.get("paged") else None}
        rec["same_on_every_rank"] = _same_on_every_rank(rec)
        out[f"mt_{name}"] = rec
    prompts, owners, kw, gen = p["mt_server"]
    cache = _tenant_cache(p, mesh, mcfg, scfg, aspec)
    server = serve.EngineServer(mcfg, scfg, params, cache=cache, mesh=mesh,
                                **kw)
    res = server.run([serve.Request(q, t) for q, t in zip(prompts, owners)],
                     gen_len=gen)
    rec = {"tokens": [r.tokens.tolist() for r in res],
           "reasons": [r.finish_reason for r in res],
           "stats": server.engine.stats().as_dict(),
           "cache": cache.stats().as_dict(),
           "signatures": server.engine.step_signatures()}
    rec["same_on_every_rank"] = _same_on_every_rank(rec)
    out["mt_server"] = rec
    return out


# --- dynamic grouping and speculation across the mesh ------------------------

def _capture_logits(engine) -> dict:
    """Every sampled row's fetched logits by (key_id, tokens sampled
    before it), as ``tests/test_torch_fleet.py capture_logits`` keys
    them."""
    seen: dict = {}
    sample = engine._sample_rows

    def recorded(rows, keys):
        for row, key in zip(rows, keys):
            seen[tuple(int(k) for k in key)] = np.asarray(row, np.float64)
        return sample(rows, keys)
    engine._sample_rows = recorded
    return seen


def _max_rel(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
               for k in want)


def _engine_fleet(p, mesh, mcfg, scfg, params):
    """The cache-routed DecodeEngine(mesh=, dynamic_grouping=True) on each
    trace of p["fleet"]["traces"] (the committed fleet trace at 3 slots,
    whose batch every replica holds whole, and at 4 slots, whose rows
    split over data), rectangular and paged, over the five fleet tenants,
    and the static engine on the same trace (rectangular): streams,
    stats, device steps, signatures, the cache's stats, the plain gathers
    and the sampled rows' logits; the dynamic rows' largest distance
    from the static ones; MultiTenantServer(mesh=, dynamic_grouping=True)
    on p["mt_server"], plain and with speculative_k=3; whether every
    rank's record equals this one's."""
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    from repro_torch.launch.engine import DecodeEngine

    aspec = S.adapter_sharding(mcfg, scfg.dora, mesh)
    fleet = p["fleet"]
    out = {}
    for name, (trace, prompts, kw) in fleet["traces"].items():
        owners = [f"t{r[3]}" for r in trace]
        logits = {}
        for form, geo in (("dynamic", {}), ("dynamic_paged", fleet["paged"]),
                          ("static", {})):
            cache = _tenant_cache(p, mesh, mcfg, scfg, aspec,
                                  fleet["tenants"])
            eng = DecodeEngine(mcfg, scfg, params, adapter_cache=cache,
                               mesh=mesh, dynamic_grouping=form != "static",
                               **kw, **geo)
            logits[form] = _capture_logits(eng)
            with _counting_plain_calls() as calls:
                streams = _drive(eng, [r[:3] for r in trace], prompts,
                                 adapter=owners)
            rec = {"streams": streams, "stats": eng.stats().as_dict(),
                   "device_steps": eng.device_steps(),
                   "signatures": eng.step_signatures(),
                   "cache": cache.stats().as_dict(),
                   "gathers": calls.get("paged_gather_plain", 0),
                   "pool": eng.pool_stats() if geo else None}
            rec["same_on_every_rank"] = _same_on_every_rank(rec)
            rec["logits"] = logits[form]
            out[f"{name}_{form}"] = rec
        out[f"{name}_dynamic"]["vs_static"] = _max_rel(logits["dynamic"],
                                                       logits["static"])
    prompts, owners, kw, gen = p["mt_server"]
    cache = _tenant_cache(p, mesh, mcfg, scfg, aspec)
    server = serve.MultiTenantServer(mcfg, scfg, params, cache=cache,
                                     mesh=mesh, dynamic_grouping=True,
                                     engine_slots=kw["slots"])
    reqs = [serve.Request(q, t) for q, t in zip(prompts, owners)]
    rec = {"plain": [t.tolist() for t in server.serve(
               reqs, gen_len=gen, max_len=kw["max_len"])],
           "speculative": [t.tolist() for t in server.serve(
               reqs, gen_len=gen, max_len=kw["max_len"], speculative_k=3)],
           "cache": cache.stats().as_dict(),
           "signatures": next(iter(server._engines.values()))
           .step_signatures()}
    rec["same_on_every_rank"] = _same_on_every_rank(rec)
    out["mt_dynamic_server"] = rec
    return out


def _engine_speculative(p, mesh, mcfg, scfg, params, adapters):
    """DecodeEngine(mesh=, speculative_k=k) on the committed speculative
    trace, rectangular and paged, each from its own mesh precompute
    (folded): with identity adapters (B = 0, m the row norm one card
    computes; the largest |g - 1| of this rank's state beside it) and
    with the perturbed ones, and the plain engine on the perturbed state;
    EngineServer(mesh=).run(speculative_k=3) of p["mt_server"] over the
    three tenants. Streams, stats, device steps, the plain gathers, pool
    stats, the cache's stats and whether every rank's equal this one's."""
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as S
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.steps import make_precompute_step
    from repro_torch.tree import flatten_paths

    spec = p["spec"]
    aspec = S.adapter_sharding(mcfg, scfg.dora, mesh)
    precompute = make_precompute_step(mcfg, scfg, mesh, fold_gsb=True)
    identity = S.shard_tree(tree_from_numpy(spec["identity"]), aspec, mesh)
    out = {}
    for kind, tree in (("identity", identity), ("perturbed", adapters)):
        state = precompute(params, tree)
        runs = [("rect", {}, spec["k"]), ("paged", spec["paged"], spec["k"])]
        if kind == "perturbed":
            runs.append(("plain", {}, 0))
        for geo_name, geo, k in runs:
            eng = DecodeEngine(mcfg, scfg, params, adapters=state, mesh=mesh,
                               speculative_k=k, **spec["kw"], **geo)
            with _counting_plain_calls() as calls:
                streams = _drive(eng, spec["trace"], spec["prompts"])
            rec = {"streams": streams, "stats": eng.stats().as_dict(),
                   "device_steps": eng.device_steps(),
                   "gathers": calls.get("paged_gather_plain", 0),
                   "pool": eng.pool_stats() if geo else None}
            rec["same_on_every_rank"] = _same_on_every_rank(rec)
            out[f"spec_{kind}_{geo_name}"] = rec
        if kind == "identity":
            out["spec_identity_rect"]["g_dev"] = max(
                float((leaf - 1).abs().max()) for name, leaf in
                flatten_paths(state).items() if name.endswith("/g"))
    prompts, owners, kw, gen = p["mt_server"]
    cache = _tenant_cache(p, mesh, mcfg, scfg, aspec)
    server = serve.EngineServer(mcfg, scfg, params, cache=cache, mesh=mesh,
                                **kw)
    res = server.run([serve.Request(q, t) for q, t in zip(prompts, owners)],
                     gen_len=gen, speculative_k=3)
    rec = {"tokens": [r.tokens.tolist() for r in res],
           "reasons": [r.finish_reason for r in res],
           "stats": server.engine.stats().as_dict(),
           "cache": cache.stats().as_dict()}
    rec["same_on_every_rank"] = _same_on_every_rank(rec)
    out["spec_server"] = rec
    return out
