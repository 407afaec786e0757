"""The model sharded over the ``model`` axis: the port on four gloo ranks on
the CPU against the JAX package on four fake XLA devices.

One module-scoped launch spawns the four ranks once (``core.spmd.launch``,
one intra-op thread a rank); they run every case of ``tests/tp_cases.py``
— reduced ff-tiny (dense), Mixtral (the ``tp`` MoE body), Kimi-K2 at
``kimi_wide`` widths (the ``ep`` body, Adafactor), Zamba2 (hybrid:
Mamba2 and the shared attention block) and ff-tiny with 16 kv heads (the
heads layout of the KV cache), each on a ``(2, 2)`` and a ``(1, 4)``
``(data, model)`` mesh — while one JAX subprocess
(``tests/tp_reference.py``) runs the reference's jitted steps over the
same meshes on the same numpy inputs, made here from a seed (fp32
parameters).  Tolerances, each from a reduction order that changes:

* two train steps at a peak rate of 1e-6: each step's loss within 2e-3
  relative (measured <= 1.6e-4) and its grad norm within 2e-2 relative
  (<= 4.7e-3); each leaf's update over the steps within ``UPDATE_TOL``
  of the reference's in the L2 norm (<= 0.17: AdamW moves an element by
  about lr x its gradient's sign, so an element whose gradient lies below
  the packages' difference moves the other way);
* the prefill logits, each decode step's logits and every cache and
  decode-state block after the prefill and after the decode steps, each
  rank's block against the reference's addressable shard of the same
  device, token by token (sequence and position): the prefill's within
  ``PREFILL_TOL`` of the block's scale (the row-parallel partials are
  summed in fp32 as XLA's CPU backend promotes the bf16 reduction, so
  the dense and hybrid prefills agree bit for bit or nearly; measured
  <= 4.4e-3), the decode steps' within ``SERVE_TOL`` (the reference's
  jitted decode step rounds fewer bf16 intermediates than an eager one:
  ``tests/test_torch_models.py`` holds the whole models to 3e-2 of their
  scale on one device; measured <= 1.9e-2).  A MoE config may miss on
  one token: a routing flip, a token whose 2nd and 3rd experts lie within
  rounding of each other (reduced Kimi-K2 on the (1, 4) mesh has one at a
  probability gap of 4.5e-4 on decode step 3), which moves that token's
  output and cache rows by ~20% of their scale.  The decode steps'
  greedy tokens equal the reference's but at a near tie of the
  reference's logits or a flip;
* each rank's block shapes of the parameters, the optimizer state, the
  caches and the decode state equal to the reference's ``NamedSharding``
  shard shapes.

The mutants (``tp_cases.MUTANTS``) must miss those bounds: a ``psum``
where the ``psum_scatter`` belongs, the gradient sum over the model axis
removed, the kv heads off by one group.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tp_cases as C
from repro_torch.configs import get
from repro_torch.core import spmd
from repro_torch.models.lm import LM
from repro_torch.models.params import walk_defs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
UPDATE_TOL = 0.3
PREFILL_TOL, SERVE_TOL = 1e-2, 3e-2
LOSS_RTOL, NORM_RTOL = 2e-3, 2e-2


# leaves drawn at the fan-in of the d_model they contract, not of the def's
# second-to-last dim (the heads, Mamba2's one group): at the def's scale
# q.k is ~16 and the reduced models' attention nearly one-hot, so a bf16
# ulp anywhere flips whole softmax rows and the reference's own meshes
# disagree on a step's grad norm by up to 10%
CONTRACT_D = ("wq", "wk", "wv", "wB", "wC")


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    for name in C.CONFIGS:
        cfg = C.config(get, name)
        pre = C.prefix(name)
        for path, d in walk_defs(LM(cfg).param_defs()):
            k = pre + "/" + "/".join(path)
            if d.init in ("zeros", "ones"):
                inp[k] = np.full(d.shape, 0.0 if d.init == "zeros" else 1.0,
                                 np.float32)
                continue
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            if path[-1] in CONTRACT_D:        # fan-in of the contracted d
                fan_in = cfg.d_model
            std = d.scale if d.init == "embed" else d.scale / np.sqrt(fan_in)
            inp[k] = (rng.standard_normal(d.shape) * std).astype(np.float32)
        tok = lambda *s: rng.integers(0, cfg.vocab, s, dtype=np.int32)
        inp[f"{pre}_train"] = tok(C.TRAIN_STEPS, C.B_TRAIN, C.S_TRAIN)
        inp[f"{pre}_prompt"] = tok(C.B_PROMPT, C.S_PROMPT)
        inp[f"{pre}_decode"] = tok(C.DECODE_STEPS, C.B_PROMPT, 1)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # one reference process per mesh, side by side (XLA's partitioner
    # writes pages of warnings: to a file, not a pipe that could fill)
    refs = []
    for shape in C.MESHES:
        tag = "{}x{}".format(*shape)
        log = open(d / f"ref{tag}.log", "w")
        refs.append((tag, log, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "tp_reference.py"),
             str(d / "in.npz"), str(d / f"ref{tag}.npz"), tag],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        ranks = spmd.launch(C.rank_main, 4, str(d / "in.npz"), device="cpu",
                            timeout_s=300)
        for _, _, p in refs:
            p.wait(timeout=300)
    finally:
        for _, log, p in refs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ref = {}
    for tag, _, p in refs:
        assert p.returncode == 0, (d / f"ref{tag}.log").read_text()[-3000:]
        ref.update(np.load(d / f"ref{tag}.npz"))
    return inp, ranks, ref


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _update_err(got, p0, want) -> float:
    d_ref = want - p0
    return float(np.linalg.norm((got - p0) - d_ref)) / max(
        float(np.linalg.norm(d_ref)), 1e-30)


def _train_errs(inp, got, ref, tag, key, pre):
    """(loss rel err, norm rel err, worst leaf update err and its path)."""
    loss = float(np.max(np.abs(got[f"{tag}/losses"] / ref[f"{key}/losses"]
                               - 1)))
    norm = float(np.max(np.abs(got[f"{tag}/grad_norms"]
                               / ref[f"{key}/grad_norms"] - 1)))
    worst = (0.0, "")
    for k in ref:
        if k.startswith(f"{key}/params/"):
            path = k[len(f"{key}/params"):]
            e = _update_err(got[f"{tag}/params{path}"], inp[pre + path],
                            ref[k])
            worst = max(worst, (e, path))
    return loss, norm, worst


def _token_errs(ranks, ref, key, what, shape, ref_key=None):
    """Per (sequence, position) of the global batch, the worst scale error
    over every rank's block of ``what`` (the logits: the prompt's last
    position, or decode step i's; a KV cache: each position it holds)
    against the reference's shard of the same device (a decode state,
    which keeps no position, under position -1)."""
    errs = {}
    for r, got in enumerate(ranks):
        for k in [k for k in got if k.startswith(f"{key}/{what}")
                  and k.endswith(f"@{r}")]:
            g = np.asarray(got[k], np.float64)
            w = np.asarray(ref[(ref_key or key) + k[len(key):]], np.float64)
            assert g.shape == w.shape, (k, g.shape, w.shape)
            d = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
            logits = "logits" in what
            b_dim = 0 if logits else 1
            b0 = (r // shape[1]) * g.shape[b_dim] if shape[0] > 1 \
                and g.shape[b_dim] < C.B_PROMPT else 0
            for b in range(g.shape[b_dim]):
                db = d[b] if logits else d[:, b]
                if logits:
                    step = what[len("decode"):-len("_logits")]
                    pos = C.S_PROMPT - 1 if what.startswith("prefill") \
                        else C.S_PROMPT + int(step)
                    cells = {pos: float(db.max())}
                elif "/ssm" in k or "/conv" in k:
                    cells = {-1: float(db.max())}
                else:                       # (layer, pos, ...) of a KV cache
                    per = db.reshape(db.shape[0], db.shape[1], -1).max(
                        axis=(0, 2))
                    cells = dict(enumerate(per.tolist()))
                for pos, e in cells.items():
                    t = (b0 + b, pos)
                    errs[t] = max(errs.get(t, 0.0), e)
    assert errs, (key, what)
    return errs


def _missed(ranks, ref, case, what):
    """The (sequence, position) tokens whose blocks of ``what`` miss
    ``SERVE_TOL``; a MoE config may miss one (a routing flip)."""
    key, moe = C.key(case), "moe" in C.config(get, case[0]).family
    tol = SERVE_TOL if what.startswith("decode") else PREFILL_TOL
    errs = _token_errs(ranks, ref, key, what, case[1])
    missed = {t for t, e in errs.items() if e > tol}
    return missed, (1 if moe else 0), max(errs.values())


CASE_IDS = [C.key(c) for c in C.CASES]


@pytest.mark.parametrize("case", C.CASES, ids=CASE_IDS)
def test_train_steps_match_the_reference(runs, case):
    inp, ranks, ref = runs
    key = C.key(case)
    for got in ranks:
        loss, norm, (upd, path) = _train_errs(inp, got, ref, key, key,
                                              C.prefix(case[0]))
        assert loss <= LOSS_RTOL, loss
        assert norm <= NORM_RTOL, norm
        assert upd <= UPDATE_TOL, (path, upd)


SERVED = ["prefill_logits", "prefill_cache"] + [
    f"decode{i}_logits" for i in range(C.DECODE_STEPS)] + ["decode_cache"]


@pytest.mark.parametrize("what", SERVED)
@pytest.mark.parametrize("case", C.CASES, ids=CASE_IDS)
def test_serving_blocks_match_the_reference_shards(runs, case, what):
    _, ranks, ref = runs
    missed, allowed, worst = _missed(ranks, ref, case, what)
    assert len(missed) <= allowed, (sorted(missed), worst)


def _whole_logits(ref, key, i, b, shape):
    """Row ``b`` of the reference's decode step ``i`` logits over the
    whole vocabulary, from its shards."""
    B_l = C.B_PROMPT // shape[0] if C.B_PROMPT % shape[0] == 0 else \
        C.B_PROMPT
    c = b // B_l if B_l < C.B_PROMPT else 0
    return np.concatenate([ref[f"{key}/decode{i}_logits@{c * shape[1] + j}"]
                           [b % B_l, -1] for j in range(shape[1])])


@pytest.mark.parametrize("case", C.CASES, ids=CASE_IDS)
def test_decode_tokens_match_the_reference(runs, case):
    """The greedy tokens equal the reference's, but where the reference's
    own logits hold a near tie (the port's token within ``SERVE_TOL`` of
    the scale below the maximum) or the step missed its bound by a
    routing flip (``_missed``)."""
    _, ranks, ref = runs
    key, shape = C.key(case), case[1]
    want = ref[f"{key}/decode_tokens"]
    flips = set()
    for i in range(C.DECODE_STEPS):
        flips |= _missed(ranks, ref, case, f"decode{i}_logits")[0]
    for got in ranks:
        tok = got[f"{key}/decode_tokens"]
        for i, b in zip(*np.nonzero(tok[..., 0] != want[..., 0])):
            lg = _whole_logits(ref, key, i, b, shape)
            scale = float(np.abs(lg).max())
            tie = lg[int(tok[i, b, 0])] >= lg.max() - SERVE_TOL * scale
            assert tie or (b, C.S_PROMPT + i) in flips, (i, b)


@pytest.mark.parametrize("kind", ["pshape", "oshape", "cshape"])
@pytest.mark.parametrize("case", C.CASES, ids=CASE_IDS)
def test_block_shapes_are_the_reference_shard_shapes(runs, case, kind):
    _, ranks, ref = runs
    key = C.key(case)
    want = {k[len(key):]: v for k, v in ref.items()
            if k.startswith(f"{key}/{kind}")}
    assert want
    for got in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(got[key + k], v, err_msg=k)
    if kind == "cshape":                 # the decode state keeps its blocks
        for got in ranks:
            for k, v in want.items():
                np.testing.assert_array_equal(
                    got[key + k.replace("/cshape", "/dshape")], v)


@pytest.mark.parametrize("mutant,case", C.MUTANTS,
                         ids=[m for m, _ in C.MUTANTS])
def test_mutants_miss_the_reference(runs, mutant, case):
    """Each mutant raises (its blocks no longer fit together) or misses
    the bound the sound run keeps."""
    inp, ranks, ref = runs
    key = C.key(case)
    tag = f"{mutant}/{key}"
    if any(int(r[f"{tag}/raised"]) for r in ranks):
        assert all(int(r[f"{tag}/raised"]) for r in ranks)
        return
    if mutant == "no_model_grad_sum":
        worst = max(_train_errs(inp, got, ref, tag, key,
                                C.prefix(case[0]))[2][0] for got in ranks)
        assert worst > UPDATE_TOL, worst
    else:
        errs = _token_errs(ranks, ref, tag, "prefill_logits", case[1], key)
        assert max(errs.values()) > PREFILL_TOL, errs
