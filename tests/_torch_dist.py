"""Multi-rank plumbing of the distributed tests: ``run_ranks`` starts a
gloo world of CPU processes (spawned, one per rank, on a free local port,
each with one intra-op thread) running one of the case functions below,
and returns each rank's result.  torch only: the cases take numpy inputs
and return numpy (or plain Python) results, which the test files hold
against the reference."""

import multiprocessing
import os
import queue
import sys
import traceback



def _rank_main(rank: int, world: int, port: int, case: str, args: tuple, out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from repro_torch.launch.mesh import init_distributed
        init_distributed("cpu")
        try:
            result = globals()[case](rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                     # reported to the test, which fails
        out.put((rank, False, traceback.format_exc()))


def run_ranks(case: str, world: int, *args, timeout: float = 300.0) -> list:
    """``case(rank, world, *args)`` on each of ``world`` gloo ranks; the
    results by rank.  Raises with a rank's traceback if it failed, and if
    the world does not finish within ``timeout`` seconds (its processes
    are killed)."""
    from repro_torch.launch.mesh import free_port
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, case, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, failures = {}, []
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            (results.__setitem__(rank, value) if ok else failures.append((rank, value)))
            if failures:
                break
    except queue.Empty:
        failures.append((-1, f"the world of {world} ranks did not finish in {timeout} s"))
    finally:
        for p in procs:
            p.join(timeout=5 if failures else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if failures:
        raise AssertionError("\n".join(f"rank {r}:\n{tb}" for r, tb in failures))
    return [results[r] for r in range(world)]


# ------------------------------------------------------------------- cases

def _mesh(shape, names=("data", "model")):
    from repro_torch.launch.mesh import _mesh
    return _mesh("cpu", tuple(shape), tuple(names))


def sp_decode(rank, world, q, k, v, lengths):
    import torch
    from repro_torch.serving.sp_decode import sp_flash_decode
    mesh = _mesh((4, 2))
    out = sp_flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(lengths), mesh)
    return out.full_tensor().numpy()


def psum(rank, world, g):
    import torch
    from repro_torch.optim import compressed_psum
    mesh = _mesh((4, 2))
    grads = {"w": torch.from_numpy(g)}
    summed, res = compressed_psum(grads, {"w": torch.zeros(g.shape)}, mesh, ("data",))
    return summed["w"].numpy(), res["w"].numpy()


def _train_cfg(arch, dtype, **train):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype),
                               train=dataclasses.replace(cfg.train, **train))


def train_step(rank, world, arch, dtype, shape, tree, batches, train):
    """The sharded step (jit_train_step on ``shape``) from the weights
    ``tree`` (or seed 0) over ``batches``, beside the port's unsharded step
    on the same: per step both losses, then the largest relative difference
    over the updated parameters."""
    import torch
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharding import full
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.training.step import jit_train_step
    cfg = _train_cfg(arch, dtype, **train)
    make = (lambda: params_from_jax(cfg, tree, device="cpu")) if tree is not None else (
        lambda: build_model(cfg, device="cpu", seed=0))
    ref = make()
    ref_state = init_train_state(ref)
    ref_step = build_train_step(ref)
    with mesh_context(_mesh(shape), cfg.parallel) as ctx:
        model = make()
        state = init_train_state(model)
        placements = {n: tuple(p.placements) for n, p in state.params.items()}
        step = jit_train_step(model, state, batches[0], ctx)
        losses = []
        for batch in batches:
            state, m = step(state, batch)
            _, rm = ref_step(ref_state, batch)
            losses.append((float(m["loss"]), float(rm["loss"])))
        rel = 0.0
        for name, p in state.params.items():
            want = ref_state.params[name].detach().float()
            got = full(p.detach()).float()
            rel = max(rel, ((got - want).abs().max() / want.abs().max().clamp(min=1e-12)).item())
    return losses, rel, {n: str(p) for n, p in placements.items()}


def serve_tp(rank, world, arch, tree, toks, steps, max_seq, engine):
    """ServeSession under a (1, 2) TP mesh against the unsharded session,
    f32, on the weights ``tree``; the RASA GEMM's calls (the plain
    version's B columns) under the mesh; and the meshed session's refusal
    of a step outside the mesh (its message)."""
    import dataclasses
    from repro_torch.config import EngineConfig
    from repro_torch.distributed import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.models import params_from_jax
    from repro_torch.serving import ServeSession
    cfg = _train_cfg(arch, "float32")
    kw = dict(block_m=128, block_k=128, block_n=128)
    cfg = dataclasses.replace(cfg, engine=EngineConfig(kind=engine, schedule="wls", **kw))
    plain = ServeSession(params_from_jax(cfg, tree, device="cpu"), max_seq,
                         device="cpu").generate(toks, steps)
    seen = []
    inner = ops.rasa_gemm_plain

    def spy(a, b, c=None, **kw):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return inner(a, b, c, **kw)

    ops.rasa_gemm_plain = spy
    try:
        with mesh_context(_mesh((1, 2)), cfg.parallel):
            model = params_from_jax(cfg, tree, device="cpu")
            session = ServeSession(model, max_seq, device="cpu")
            meshed = session.generate(toks, steps)
            placements = {n: str(tuple(p.placements)) for n, p in model.named_parameters()}
    finally:
        ops.rasa_gemm_plain = inner
    try:
        session.generate(toks, 1)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return plain.numpy(), meshed.numpy(), seen, placements, refused


def checkpoint_reshard(rank, world, directory):
    """A train state written on (2, 2) (after one step) restored onto (1, 2)
    and, on rank 0, onto no mesh; and a checkpoint written without a mesh
    restored onto (2, 2).  Returns the gathered leaves of each."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint, restore_into, save_checkpoint
    from repro_torch.checkpoint.store import flatten_with_names
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharding import full
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state
    from repro_torch.training.step import jit_train_step, state_shardings
    cfg = _train_cfg("qwen3-1.7b", "float32", lr=1e-2, warmup_steps=1, total_steps=4)
    data = SyntheticLMDataset(cfg.model, seq_len=16, global_batch=4, seed=0)
    gathered = lambda st: {n: full(t).detach().clone().numpy()
                           for n, t in flatten_with_names(st)}
    out = {}
    with mesh_context(_mesh((2, 2)), cfg.parallel) as ctx:
        model = build_model(cfg, device="cpu", seed=0)
        state = init_train_state(model)
        step = jit_train_step(model, state, data.batch(0), ctx)
        for s in range(2):
            step(state, data.batch(s))
        save_checkpoint(f"{directory}/meshed", 2, state)
        out["written"] = gathered(state)
    group = dist.new_group([0, 1])
    mesh_1x2 = _mesh((1, 2))       # every rank takes part in making it; ranks 0-1 use it
    if rank < 2:
        with mesh_context(mesh_1x2, cfg.parallel) as ctx:
            model = build_model(cfg, device="cpu", seed=1)
            fresh = init_train_state(model)
            shard = state_shardings(model, fresh, ctx)
            restored, at = restore_checkpoint(f"{directory}/meshed", fresh, shardings=shard)
            out["onto_1x2"] = gathered(restored)
            out["onto_1x2_placements"] = {n: str(tuple(t.placements))
                                          for n, t in restored.params.items()}
            restore_into(f"{directory}/meshed", fresh, shardings=shard)
            out["into_1x2"] = gathered(fresh)
        dist.barrier(group)
    if rank == 0:
        plain = init_train_state(build_model(cfg, device="cpu", seed=1))
        restored, _ = restore_checkpoint(f"{directory}/meshed", plain)
        out["onto_none"] = gathered(restored)
        save_checkpoint(f"{directory}/plain", 2, restored)
    dist.barrier()
    with mesh_context(_mesh((2, 2)), cfg.parallel):
        fresh = init_train_state(build_model(cfg, device="cpu", seed=2))
        restore_into(f"{directory}/plain", fresh)
        out["plain_onto_2x2"] = gathered(fresh)
    return out


def pipeline(rank, world, params, x):
    """pipeline_apply over a (4,) "pod" mesh: the output and the gradients
    of its sum (each rank's share, summed over the ranks)."""
    import torch
    import torch.distributed as dist
    from repro_torch.training.pipeline import pipeline_apply, split_stages
    mesh = _mesh((4,), ("pod",))
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)

    def stage_fn(sp, h):
        for i in range(sp["w"].shape[0]):
            h = torch.tanh(h @ sp["w"][i] + sp["b"][i])
        return h

    y = pipeline_apply(split_stages(p, 4), xt, stage_fn, mesh, axis="pod", n_microbatches=4)
    y.sum().backward()
    grads = {k: v.grad.clone() for k, v in p.items()}
    grads["x"] = xt.grad.clone()
    for g in grads.values():
        dist.all_reduce(g)
    return y.detach().numpy(), {k: g.numpy() for k, g in grads.items()}


if __name__ == "__main__":
    sys.exit("a module of test helpers")


def sp_serve(rank, world):
    """Greedy serving (f32 smoke, seed 0, batch 2, prompt 6, 3 decode steps,
    max_seq 16) under a mesh against the unsharded session: qwen3-1.7b and
    zamba2-2.7b with sequence_parallel_decode on (2, 1), the cache split
    along the sequence (positions 6 and 7 on rank 0, 8 on rank 1);
    granite-moe-3b-a800m on (1, 2).  Per arch: (meshed, unsharded, the
    stacked k cache's placements), each with its tokens and its prefill and
    decode logits."""
    import dataclasses
    import torch
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.models import build_model
    from repro_torch.models.transformer import prompt_shape
    from repro_torch.serving import ServeSession

    def run(session, prompts):
        logits = session.prefill(prompts).clone()
        first, decode, tokens = logits, [], []
        for _ in range(3):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens.append(tok)
            logits = session.decode_step(tok).clone()
            decode.append(logits)
        return {"prefill": first.numpy(), "decode": torch.stack(decode).numpy(),
                "tokens": torch.stack(tokens).numpy()}

    out = {}
    for arch, shape, sp in (("qwen3-1.7b", (2, 1), True), ("zamba2-2.7b", (2, 1), True),
                            ("granite-moe-3b-a800m", (1, 2), False)):
        cfg = _train_cfg(arch, "float32")
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, sequence_parallel_decode=sp))
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.model.vocab, prompt_shape(cfg.model, 2, 6),
                                generator=gen, dtype=torch.int32)
        plain = run(ServeSession(build_model(cfg, device="cpu", seed=0), max_seq=16,
                                 device="cpu"), prompts)
        with mesh_context(_mesh(shape), cfg.parallel):
            session = ServeSession(build_model(cfg, device="cpu", seed=0), max_seq=16,
                                   device="cpu")
            meshed = run(session, prompts)
            k = session._slots[2][0].buffers[0]
            placements = str(tuple(k.placements)) if is_dtensor(k) else "plain"
        out[arch] = (meshed, plain, placements)
    return out
