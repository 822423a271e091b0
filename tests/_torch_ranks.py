"""Helpers for the port's multi-rank CPU tests: ranks spawned with
``torch.multiprocessing`` into one gloo group over a ``FileStore``, each
returning its result through a file.  The module imports torch and the
port only, so a spawned rank starts quickly."""
import contextlib
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A one-rank gloo group for this process, or the group it already
    holds (the port's drivers start one where none exists and keep it)."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.FileStore(
            str(Path(tmp_path) / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def _rank_main(rank, world, tmp, fn, args):
    store = dist.FileStore(str(Path(tmp) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, Path(tmp) / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, tmp_path, *args, timeout=120.0):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result in rank order.  Fails, and ends the ranks, after
    ``timeout`` seconds.  ``fn`` must be importable (a module-level function
    of a module on the path)."""
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_path), fn, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish in {timeout} s")
    return [torch.load(Path(tmp_path) / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def compress_rank(rank, world, grads_by_rank, err_by_rank):
    """``compressed_psum`` of this rank's gradients, and the payload and
    scales it agreed on."""
    from repro_torch.optim import compress as C
    g = {k: torch.from_numpy(v) for k, v in grads_by_rank[rank].items()}
    e = {k: torch.from_numpy(v) for k, v in err_by_rank[rank].items()}
    mean, new_e = C.compressed_psum(g, e)
    blocks = [C._blocks(g[k], e[k]) for k in sorted(g)]
    absmax = torch.cat([b.abs().amax(1) for b in blocks])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX)
    scale = C.shared_scale(absmax)
    q = C.quantize(torch.cat(blocks), scale)
    return {"mean": {k: v.numpy() for k, v in mean.items()},
            "err": {k: v.numpy() for k, v in new_e.items()},
            "q": q.numpy(), "scale": scale.numpy()}


def mac_run(pol, n_cells, seed, mesh=None):
    """Three slots of a ``MultiCellVecMac`` on the CPU over ``n_cells``
    cells with random request batches: each slot's reports, then the
    policy state and each cell's generator state."""
    import numpy as np

    from repro_torch.core import ran as RAN
    from repro_torch.core.engine_vec import MultiCellVecMac
    rng = np.random.default_rng(seed)
    mac = MultiCellVecMac([RAN.RanCell(policy=RAN.make_policy(pol),
                                       cfg=RAN.RanConfig(n_prbs=24))
                           for _ in range(n_cells)], device="cpu", mesh=mesh)
    gens = [np.random.default_rng(k)
            for k in np.random.SeedSequence(seed).spawn(n_cells)]
    slots = []
    for _ in range(3):
        batches = []
        for _ in range(n_cells):
            m = int(rng.integers(0, 12))
            enq = rng.random(m) * 0.01
            batches.append(dict(
                ue=rng.choice(80, size=m, replace=False),
                n_bytes=rng.integers(2_000, 60_000, m), enq=enq,
                dead=enq + 0.05 + rng.random(m) * 0.05,
                link_rate_bps=10.0 ** rng.uniform(7.3, 8.3, m)))
        slots.append(mac.serve_slot_arrays(batches, gens))
    return {"slots": slots, "rr": mac._rr_ptr, "pf": mac._pf_avg,
            "gens": [g.bit_generator.state for g in gens]}


def mac_rank(rank, world, pol, n_cells, seed):
    from repro_torch.launch.mesh import make_host_mesh
    return mac_run(pol, n_cells, seed, make_host_mesh(device="cpu"))


def train_rank(rank, world, arch, params_np, batch_np, fsdp, opt_kw):
    """One step of the reduced ``arch`` through ``build_train_step`` on a
    (world, 1) mesh: the metrics and the updated parameters, gathered."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import ShardingRules, gather
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_map
    cfg = get_reduced_config(arch)
    B, S = batch_np["tokens"].shape
    opt = AdamW(**opt_kw)
    step = build_train_step(cfg, InputShape("t", S, B, "train"),
                            mesh=make_host_mesh(device="cpu"), opt=opt,
                            rules=ShardingRules(fsdp=fsdp), seq_shard=False)
    params = lm_params_from_numpy(params_np, torch.device("cpu"))
    placed, state = step.place(params, opt.init(params))
    shards = tree_map(lambda x: tuple(x.to_local().shape), placed)
    new, _, m = step(placed, state, {k: torch.from_numpy(v)
                                     for k, v in batch_np.items()})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": tree_map(lambda x: x.numpy(), gather(new)),
            "shards": shards}


def tp_train_rank(rank, world, cases, opt_kw, seq_shard):
    """One step of ``build_train_step`` (with ``seq_shard``) for each case
    (arch, (data, model), weights, batch, fsdp) on a mesh of that shape
    over these ranks: the metrics and the updated parameters, gathered."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import ShardingRules, gather
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    out = []
    for arch, (data, model), params_np, batch_np, fsdp in cases:
        cfg = get_reduced_config(arch)
        B, S = batch_np["tokens"].shape
        opt = AdamW(**opt_kw)
        mesh = make_host_mesh(model_parallel=model, device="cpu")
        assert mesh.shape == {"data": data, "model": model}
        step = build_train_step(cfg, InputShape("t", S, B, "train"),
                                mesh=mesh, opt=opt,
                                rules=ShardingRules(fsdp=fsdp),
                                seq_shard=seq_shard)
        params = lm_params_from_numpy(params_np, torch.device("cpu"))
        placed, state = step.place(params, opt.init(params))
        new, _, m = step(placed, state, {k: torch.from_numpy(v)
                                         for k, v in batch_np.items()})
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": tree_map(lambda x: x.numpy(), gather(new))})
    return out


def sp_train_rank(rank, world, cases, opt_kw):
    """One step of ``build_train_step(mesh=..., seq_shard=...)`` for each
    case (arch, config changes, (data, model), weights, batch, seq_shard)
    on a mesh of that shape over these ranks: the metrics, the updated
    parameters gathered, and whether the step cut the sequence."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.steps import build_train_step, seq_cut
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    out = []
    for arch, over, (data, model), params_np, batch_np, seq_shard in cases:
        cfg = get_reduced_config(arch).replace(**over)
        B, S = batch_np["labels"].shape[:2]
        shape = InputShape("t", S, B, "train")
        opt = AdamW(**opt_kw)
        mesh = make_host_mesh(model_parallel=model, device="cpu")
        assert mesh.shape == {"data": data, "model": model}
        step = build_train_step(cfg, shape, mesh=mesh, opt=opt,
                                seq_shard=seq_shard)
        params = lm_params_from_numpy(params_np, torch.device("cpu"))
        placed, state = step.place(params, opt.init(params))
        new, _, m = step(placed, state, {k: torch.from_numpy(v)
                                         for k, v in batch_np.items()})
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": tree_map(lambda x: x.numpy(), gather(new)),
                    "seq": seq_cut(mesh, cfg, shape, seq_shard=seq_shard)})
    return out


def seq_ops_rank(rank, world, x_np, g_np):
    """The sequence operators of ``collectives`` on this rank's chunk (or,
    for the whole-input ones, the whole) of ``x_np`` (B, S, d), each with
    this rank's upstream gradient ``g_np[rank]`` (the output's shape):
    under ``model_parallel(seq=True)`` the outputs and the input gradients,
    and outside it (the identity) whether each returned its input."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model_parallel=world, device="cpu")
    whole = torch.from_numpy(x_np)
    mine = whole.chunk(world, 1)[rank]
    ops = {"gather_seq": (C.gather_seq, mine),
           "gather_seq_whole": (C.gather_seq_whole, mine),
           "scatter_seq": (C.scatter_seq, whole),
           "split_seq": (C.split_seq, whole),
           "seq_weight": (C.seq_weight, whole[0, 0])}
    out = {}
    with C.model_parallel(mesh.group("model"), seq=True):
        assert C.seq_sharded()
        for name, (fn, x) in ops.items():
            x = x.clone().requires_grad_(True)
            y = fn(x)
            g = torch.from_numpy(g_np[name][rank])
            y.backward(g)
            out[name] = (y.detach().numpy(), x.grad.numpy())
    with C.model_parallel(mesh.group("model")):
        out["tp_identity"] = all(fn(x) is x for fn, x in ops.values())
    out["outside_identity"] = all(fn(x) is x for fn, x in ops.values())
    return out


def _unshard(tree, spec_tree, mesh):
    """Each leaf of ``tree`` (this rank's chunk by its spec) gathered whole
    over every axis its spec names, innermost first."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch.sharding import entry_axes
    from repro_torch.tree import spec_map

    def one(spec, x):
        for d, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                x = C.all_gather(x, mesh.group(a), d)
        return x
    return spec_map(one, spec_tree, tree)


def tp_forward_rank(rank, world, cases):
    """For each case (arch, weights, batch, labels or None) on a (1, world)
    mesh: the prefill's last-position logits (labels None) and this rank's
    chunk of every cache leaf with its mesh coordinate, or the loss
    and every gradient leaf of ``value_and_grad`` on the rank's shards,
    gathered whole; and the rank's chunk of every leaf."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (ShardingRules, param_shardings,
                                             shard)
    from repro_torch.launch.steps import build_prefill, value_and_grad
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    mesh = make_host_mesh(model_parallel=world, device="cpu")
    out = []
    for arch, params_np, batch_np in cases:
        cfg = get_reduced_config(arch)
        params = lm_params_from_numpy(params_np, torch.device("cpu"))
        model = get_model(cfg, "cpu")
        specs = param_shardings(ShardingRules(), model.spec(),
                                model.abstract_params(), mesh)
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        mine = shard(params, specs, mesh)
        got = {"chunks": tree_map(lambda x: x.numpy().copy(), mine)}
        if "labels" in batch:
            with C.model_parallel(mesh.group("model")):
                loss, grads = value_and_grad(cfg, mine, batch)
            got.update(loss=float(loss), grads=tree_map(
                lambda g: g.numpy(), _unshard(grads, specs, mesh)))
        else:
            B = next(iter(batch.values())).shape[0]
            S = sum(v.shape[1] for v in batch.values())
            pre = build_prefill(cfg, InputShape("p", S, B, "prefill"),
                                mesh=mesh)
            logits, caches = pre.local_fn(mine, batch)
            got.update(logits=logits.numpy(), coord=mesh.coordinate(),
                       caches=tree_map(lambda c: c.numpy(), caches))
        out.append(got)
    return out


def tp_decode_rank(rank, world, cases):
    """For each case (arch, config overrides, (data, model), weights,
    prompt, decode batches, max_len) on a mesh of that shape over these
    ranks: ``build_prefill(mesh=)`` of the prompt into caches of max_len
    rows, then one ``build_decode_step(mesh=)`` per decode batch at the
    positions after the prompt.  Returns per case the prefill's and each
    step's gathered logits, this rank's chunk of every cache leaf after the
    prefill and after the last step, and its mesh coordinate."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import local
    from repro_torch.launch.steps import build_decode_step, build_prefill
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    out = []
    for arch, over, (data, model), params_np, prompt_np, steps_np, max_len \
            in cases:
        cfg = get_reduced_config(arch).replace(**over)
        mesh = make_host_mesh(model_parallel=model, device="cpu")
        assert mesh.shape == {"data": data, "model": model}
        B = next(iter(prompt_np.values())).shape[0]
        S = sum(v.shape[1] for v in prompt_np.values())
        pre = build_prefill(cfg, InputShape("p", S, B, "prefill"), mesh=mesh,
                            max_len=max_len)
        dec = build_decode_step(cfg, InputShape("d", max_len, B, "decode"),
                                mesh=mesh)
        params = pre.place(lm_params_from_numpy(params_np,
                                                torch.device("cpu")))
        logits, caches = pre(params, {k: torch.from_numpy(v)
                                      for k, v in prompt_np.items()})
        got = {"prefill": logits.numpy(), "coord": mesh.coordinate(),
               "chunks0": tree_map(lambda c: c.numpy().copy(),
                                   local(caches)), "logits": []}
        for i, b in enumerate(steps_np):
            logits, caches = dec(params, caches, {
                k: torch.from_numpy(v) for k, v in b.items()}, S + i)
            got["logits"].append(logits.numpy())
        got["chunks"] = tree_map(lambda c: c.numpy().copy(), local(caches))
        out.append(got)
    return out
