"""The JAX package's side of ``tests/test_torch_spmd.py``, run as one
subprocess over 4 fake XLA CPU devices:

    python tests/spmd_reference.py INPUTS.npz OUT.npz CKPT_DIR

It first writes the reference's checkpoint of reduced Mixtral's initial
state under CKPT_DIR (the port's ranks restore it) and marks it done, then
computes each case on the same numpy inputs as the port's ranks
(``tests/spmd_cases.py``) and saves the results.  The train steps run
jitted with XLA's excess precision off, as ``tests/test_torch_train.py``
runs them.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses  # noqa: E402
import pathlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.checkpoint.reshard import reshard_state  # noqa: E402
from repro.configs import get  # noqa: E402
from repro.core.device import (a2a_dispatch, farm_map,  # noqa: E402
                               flash_decode_combine, pipeline_shard,
                               shard_map, tensor_map)
from repro.core.plan import ShardingPlan  # noqa: E402
from repro.models.lm import (LM, vocab_parallel_ce,  # noqa: E402
                             vocab_parallel_embed)
from repro.optim.schedules import cosine_warmup  # noqa: E402
from repro.runtime.steps import (init_state, make_train_step,  # noqa: E402
                                 state_shardings)

NO_EXCESS = {"xla_allow_excess_precision": False}


def mesh(shape, names, first=0):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[first:first + n]).reshape(shape),
                names)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _params(inp, prefix, like):
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return jnp.asarray(inp[path], jnp.float32)
    return walk(like, prefix)


def train(inp, cfg, prefix, out, tag):
    steps, lr = int(inp["train_steps"]), float(inp["train_lr"])
    plan = ShardingPlan(mesh((2, 1), ("data", "model")))
    params = _params(inp, prefix, LM(cfg).param_defs())
    from repro.optim import make_optimizer
    state = {"params": params,
             "opt": make_optimizer(cfg.optimizer).init(params),
             "step": jnp.zeros((), jnp.int32)}
    sh = state_shardings(cfg, plan)
    state = jax.device_put(state, sh)
    bsh = {"tokens": NamedSharding(plan.mesh, P("data", None))}
    step = make_train_step(cfg, plan, cosine_warmup(lr, 20, steps))
    batch = {"tokens": jnp.asarray(inp[f"{prefix}_tok"][0])}
    f = jax.jit(step, in_shardings=(sh, bsh)).lower(state, batch).compile(
        compiler_options=NO_EXCESS)
    losses = []
    for i in range(steps):
        state, m = f(state, {"tokens": jnp.asarray(inp[f"{prefix}_tok"][i])})
        losses.append(float(m["loss"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    for path, a in _paths(state["params"]):
        out[f"{tag}/params{path}"] = np.asarray(a, np.float32)


def checkpoint(cfg, ckpt_dir, out):
    """The reference's initial state of ``cfg`` saved as a checkpoint, and
    each leaf's addressable shard per device on a data=2 mesh."""
    plan = ShardingPlan(mesh((2, 1), ("data", "model")))
    state = init_state(cfg, plan, jax.random.PRNGKey(3))
    save_checkpoint(ckpt_dir, 0, state)
    (pathlib.Path(ckpt_dir) / "done").touch()
    host = jax.tree.map(np.asarray, state)
    placed = reshard_state(cfg, host, plan)
    for path, a in _paths(placed):
        for s in a.addressable_shards:
            out[f"restore{path}@{s.device.id}"] = np.asarray(s.data,
                                                             np.float32)


def main(inp_path, out_path, ckpt_dir):
    inp = dict(np.load(inp_path))
    out = {}
    mix = get("mixtral-8x7b").reduced()
    checkpoint(mix, ckpt_dir, out)

    m_data = mesh((4,), ("data",))
    w = jnp.asarray(inp["farm_w"])
    out["farm"] = farm_map(lambda x: jnp.tanh(x @ w), m_data)(inp["farm_x"])
    out["farm_reduce"] = farm_map(lambda x: x.sum(0), m_data,
                                  reduce_outputs=True)(inp["farm_x"])

    m22 = mesh((2, 2), ("data", "model"))
    out["tm_reduce"] = tensor_map(
        lambda a, b: a @ b, m22, axis="model",
        split_spec=(P(None, "model"), P("model", None)),
        compose="reduce")(inp["tm_a"], inp["tm_b"])
    out["tm_gather"] = tensor_map(
        lambda x, w: x @ w, m22, axis="model",
        split_spec=(P(), P(None, "model")), out_axis=1)(inp["tm_x"], inp["tm_w"])

    run = pipeline_shard(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                         mesh((4,), ("stage",)), "stage", n_microbatches=8)
    out["pipe"] = run({"w": jnp.asarray(inp["pipe_w"]),
                       "b": jnp.asarray(inp["pipe_b"])},
                      jnp.asarray(inp["pipe_x"]))

    def local_attn(q, kl, vl):
        d = q.shape[-1]
        s = jnp.einsum("bhd,bkhd->bhk", q, kl) / jnp.sqrt(d)
        m = jnp.max(s, -1)
        p = jnp.exp(s - m[..., None])
        o = jnp.einsum("bhk,bkhd->bhd", p, vl) / jnp.maximum(
            jnp.sum(p, -1), 1e-30)[..., None]
        lse = jnp.log(jnp.sum(p, -1)) + m
        return flash_decode_combine(o, lse, "model")
    kv = P(None, "model", None, None)
    out["flash_decode"] = shard_map(local_attn, m22, (P(), kv, kv), P(),
                                    check_rep=False)(
        inp["fd_q"], inp["fd_k"], inp["fd_v"])

    c, d = [float(v) for v in inp["a2a_c"]], [float(v) for v in inp["a2a_d"]]
    lefts = [lambda x: x * 2.0 + 1.0, lambda x: x - 3.0]
    rights = [(lambda y, e=e: y * c[e]) if e % 2 else
              (lambda y, e=e: y + d[e]) for e in range(4)]
    xs = jnp.asarray(inp["a2a_x"])
    hop = a2a_dispatch(lefts, rights, mesh=m22, axis="data", interpret=True)
    out["a2a"] = hop(xs, jnp.arange(xs.shape[0], dtype=jnp.int32))

    plan22 = ShardingPlan(m22)
    tok = jnp.asarray(inp["vp_tok"])
    out["vp_embed"] = vocab_parallel_embed(tok, jnp.asarray(inp["vp_emb"]),
                                           plan22).astype(jnp.float32)
    out["vp_embed_grad"] = jax.grad(
        lambda emb: jnp.sum(vocab_parallel_embed(tok, emb, plan22)
                            .astype(jnp.float32) ** 2))(
        jnp.asarray(inp["vp_emb"]))
    lab, msk = jnp.asarray(inp["vp_lab"]), jnp.asarray(inp["vp_mask"])
    loss, (gx, gw) = jax.value_and_grad(
        lambda x, w: vocab_parallel_ce(x, w, lab, msk, plan22), (0, 1))(
        jnp.asarray(inp["vp_x"]), jnp.asarray(inp["vp_w"]))
    out["vp_loss"], out["vp_gx"], out["vp_gw"] = loss, gx, gw

    train(inp, mix, "mix", out, "train")
    widths = dict(zip(("d_model", "moe_d_ff", "d_ff"),
                      (int(v) for v in inp["kimi_widths"])))
    train(inp, dataclasses.replace(get("kimi-k2-1t-a32b").reduced(),
                                   **widths), "kimi", out, "adafactor")
    np.savez(out_path, **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})


if __name__ == "__main__":
    main(*sys.argv[1:4])
