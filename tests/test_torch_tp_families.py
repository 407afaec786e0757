"""The encdec, vlm and ssm families and context-parallel attention over the
``model`` axis: the port on four gloo ranks on the CPU against the JAX
package on four fake XLA devices.

One module-scoped launch spawns the four ranks once (``core.spmd.launch``,
one intra-op thread a rank); they run every case of
``tests/tp_family_cases.py`` — reduced Whisper (the encoder over sequence
blocks, the self-attention cache in the head_dim layout, the cross cache
over its 2 kv heads where they divide the axis) and a 16-kv-head Whisper
(the heads layout of both, as at full width), reduced Qwen2-VL
(context-parallel attention) fed tokens and fed embeddings with M-RoPE
ids, reduced xLSTM (the mLSTM and sLSTM blocks and their states; also at
2 heads, which a model axis of 4 leaves whole) and
reduced Llama-3.2-3B (cp), also at a prompt of 14 that a model axis of 4
leaves whole, each on a ``(2, 2)`` and a ``(1, 4)`` ``(data, model)`` mesh
— while one JAX subprocess per mesh (``tests/tp_family_reference.py``) runs
the reference's jitted steps on the same numpy inputs, made here from a
seed.  The bounds are ``tests/test_torch_tp.py``'s (its docstring says
where each comes from), but for Whisper:

* Whisper runs on bf16 parameters (the reference's encdec steps do not
  trace with fp32 ones) at a peak rate of 1e-3, so that they move (an
  update of about one bf16 ulp), and its prefill, whose logits and caches
  are bf16 products, is held to
  ``BF16_PREFILL_TOL``, two bf16 steps at their scale where the fp32
  configs take ``PREFILL_TOL`` (one step is 7.8e-3).

The caches and states are held as in ``tests/test_torch_tp.py``: a decode
state (mLSTM, sLSTM) keeps no position, a cross cache holds the encoder's
frames as positions; a state the port keeps whole where GSPMD tiles it its
own way (xLSTM's 2 heads on a model axis of 4) is held to the reference's
whole state.  ``-s`` prints each check's margin.

Reduced random Whisper is chaotic (a 1e-3 change of its parameters moves
its gradient by its own size on one device), so its q/k/v are drawn at the
fan-in of the d_model they contract, as ``tests/test_torch_tp.py`` draws
them for every config.

The mutants (``tp_family_cases.MUTANTS``) must miss those bounds: cp
attention reading every key instead of the prefix up to its block's last
row, the gradient sum over the model axis removed under cp, the mLSTM
state's heads one block off.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tp_family_cases as C
from repro_torch.configs import get
from repro_torch.core import spmd
from repro_torch.models.lm import LM
from repro_torch.models.params import walk_defs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
UPDATE_TOL = 0.3
PREFILL_TOL, BF16_PREFILL_TOL, SERVE_TOL = 1e-2, 2e-2, 3e-2
LOSS_RTOL, NORM_RTOL = 2e-3, 2e-2
# attention's q/k/v (self and cross) at the fan-in of the d_model they
# contract, not of the def's second-to-last dim (the heads)
CONTRACT_D = ("wq", "wk", "wv")


def mrope_ids(B: int, S: int, before: int = 2, rows: int = 3,
              cols: int = 4) -> np.ndarray:
    """(3, B, S) M-RoPE ids: ``before`` text tokens, a rows x cols grid of
    vision embeddings, then text."""
    n = rows * cols
    ids = np.empty((3, S), np.int32)
    ids[:, :before] = np.arange(before)
    r, c = np.divmod(np.arange(n), cols)
    ids[0, before:before + n] = before
    ids[1, before:before + n] = before + r
    ids[2, before:before + n] = before + c
    ids[:, before + n:] = np.arange(before + n, S) - (n - max(rows, cols))
    return np.broadcast_to(ids[:, None], (3, B, S)).copy()


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
            if path[-1] in CONTRACT_D and path[-2] in ("attn", "xattn"):
                fan_in = cfg.d_model
            std = d.scale if d.init == "embed" else d.scale / np.sqrt(fan_in)
            inp[k] = (rng.standard_normal(d.shape) * std).astype(np.float32)
        tok = lambda *s: rng.integers(0, cfg.vocab, s, dtype=np.int32)
        S = C.s_prompt(name)
        inp[f"{pre}_train"] = tok(C.TRAIN_STEPS, C.B_TRAIN, C.S_TRAIN)
        inp[f"{pre}_prompt"] = tok(C.B_PROMPT, S)
        inp[f"{pre}_decode"] = tok(C.DECODE_STEPS, C.B_PROMPT, 1)
        normal = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
        if cfg.family == "encdec":
            inp[f"{pre}_train_frames"] = normal(
                C.TRAIN_STEPS, C.B_TRAIN, C.S_ENC, cfg.d_model)
            inp[f"{pre}_prompt_frames"] = normal(C.B_PROMPT, C.S_ENC,
                                                 cfg.d_model)
        if name == "qwen2-vl-embeds":
            inp[f"{pre}_train_embeds"] = normal(C.TRAIN_STEPS, C.B_TRAIN,
                                                C.S_TRAIN, cfg.d_model)
            inp[f"{pre}_train_mrope_positions"] = np.stack(
                [mrope_ids(C.B_TRAIN, C.S_TRAIN)] * C.TRAIN_STEPS)
            inp[f"{pre}_prompt_embeds"] = normal(C.B_PROMPT, S, cfg.d_model)
            inp[f"{pre}_prompt_mrope_positions"] = mrope_ids(C.B_PROMPT, S)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_families")
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
            [sys.executable, str(ROOT / "tests" / "tp_family_reference.py"),
             str(d / "in.npz"), str(d / f"ref{tag}.npz"), tag],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        ranks = spmd.launch(C.rank_main, 4, str(d / "in.npz"), device="cpu",
                            timeout_s=400)
        for _, _, p in refs:
            p.wait(timeout=400)
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


def _update_err(got, p0, want) -> float:
    d_ref = want - p0
    return float(np.linalg.norm((got - p0) - d_ref)) / max(
        float(np.linalg.norm(d_ref)), 1e-30)


def _train_errs(inp, got, ref, tag, key, name):
    """(loss rel err, norm rel err, worst leaf update err and its path)."""
    pre = C.prefix(name)
    loss = float(np.max(np.abs(got[f"{tag}/losses"] / ref[f"{key}/losses"]
                               - 1)))
    norm = float(np.max(np.abs(got[f"{tag}/grad_norms"]
                               / ref[f"{key}/grad_norms"] - 1)))
    worst = (0.0, "")
    for k in ref:
        if k.startswith(f"{key}/params/"):
            path = k[len(f"{key}/params"):]
            p0 = inp[pre + path]
            if C.bf16_params(name):          # the parameters as drawn
                p0 = torch.from_numpy(p0).to(torch.bfloat16).float().numpy()
            e = _update_err(got[f"{tag}/params{path}"], p0, ref[k])
            worst = max(worst, (e, path))
    return loss, norm, worst


def _is_state(k: str) -> bool:
    """A decode-state leaf, which keeps no position."""
    return any(f"/{kind}/" in k for kind in ("mamba2", "mlstm", "slstm"))


def _token_errs(ranks, ref, key, what, shape, S, ref_key=None):
    """Per (sequence, position) of the global batch, the worst scale error
    over every rank's block of ``what`` (the logits: the prompt's last
    position, or decode step i's; a KV cache: each position it holds, the
    encoder's frames for a cross cache) against the reference's shard of
    the same device (a decode state under position -1)."""
    errs = {}
    for r, got in enumerate(ranks):
        for k in [k for k in got if k.startswith(f"{key}/{what}")
                  and k.endswith(f"@{r}")]:
            g = np.asarray(got[k], np.float64)
            w = np.asarray(ref[(ref_key or key) + k[len(key):]], np.float64)
            whole = (ref_key or key) + k[len(key):].replace(
                what, what + "_whole", 1).rsplit("@", 1)[0]
            if g.shape != w.shape and whole in ref \
                    and ref[whole].shape == g.shape:
                w = np.asarray(ref[whole], np.float64)  # the state kept whole
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
                    pos = S - 1 if what.startswith("prefill") \
                        else S + int(step)
                    cells = {pos: float(db.max())}
                elif _is_state(k):
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
    """The (sequence, position) tokens whose blocks of ``what`` miss their
    bound, and the worst error."""
    tol = SERVE_TOL if what.startswith("decode") else \
        BF16_PREFILL_TOL if C.bf16_params(case[0]) else PREFILL_TOL
    errs = _token_errs(ranks, ref, C.key(case), what, case[1],
                       C.s_prompt(case[0]))
    return {t for t, e in errs.items() if e > tol}, max(errs.values())


CASE_IDS = [C.key(c) for c in C.CASES]
TRAINED = [c for c in C.CASES if c[0] not in C.SERVE_ONLY]


@pytest.mark.parametrize("case", TRAINED, ids=[C.key(c) for c in TRAINED])
def test_train_steps_match_the_reference(runs, case):
    inp, ranks, ref = runs
    key = C.key(case)
    loss, norm, (upd, path) = max(_train_errs(inp, got, ref, key, key,
                                              case[0]) for got in ranks)
    print(f"[margin] {key} train: loss {loss:.2e} (bound {LOSS_RTOL}), "
          f"grad norm {norm:.2e} ({NORM_RTOL}), worst update {upd:.4f} at "
          f"{path} ({UPDATE_TOL})")
    for got in ranks:
        loss, norm, (upd, path) = _train_errs(inp, got, ref, key, key,
                                              case[0])
        assert loss <= LOSS_RTOL, loss
        assert norm <= NORM_RTOL, norm
        assert upd <= UPDATE_TOL, (path, upd)


SERVED = ["prefill_logits", "prefill_cache"] + [
    f"decode{i}_logits" for i in range(C.DECODE_STEPS)] + ["decode_cache"]


@pytest.mark.parametrize("what", SERVED)
@pytest.mark.parametrize("case", C.CASES, ids=CASE_IDS)
def test_serving_blocks_match_the_reference_shards(runs, case, what):
    _, ranks, ref = runs
    missed, worst = _missed(ranks, ref, case, what)
    print(f"[margin] {C.key(case)} {what}: {worst:.2e}")
    assert not missed, (sorted(missed), worst)


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
    the scale below the maximum)."""
    _, ranks, ref = runs
    key, shape = C.key(case), case[1]
    want = ref[f"{key}/decode_tokens"]
    for got in ranks:
        tok = got[f"{key}/decode_tokens"]
        for i, b in zip(*np.nonzero(tok[..., 0] != want[..., 0])):
            lg = _whole_logits(ref, key, i, b, shape)
            scale = float(np.abs(lg).max())
            assert lg[int(tok[i, b, 0])] >= lg.max() - SERVE_TOL * scale, \
                (i, b)


SHAPES = [(c, kind) for c in C.CASES for kind in (
    ("cshape",) if c[0] in C.SERVE_ONLY else ("pshape", "oshape",
                                              "cshape"))]


@pytest.mark.parametrize("case,kind", SHAPES,
                         ids=[f"{C.key(c)}-{k}" for c, k in SHAPES])
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
        worst = max(_train_errs(inp, got, ref, tag, key, case[0])[2][0]
                    for got in ranks)
        print(f"[margin] {tag}: worst update {worst:.4f} (must exceed "
              f"{UPDATE_TOL})")
        assert worst > UPDATE_TOL, worst
        return
    what = "prefill_logits" if mutant == "cp_full_keys" else "prefill_cache"
    errs = _token_errs(ranks, ref, tag, what, case[1], C.s_prompt(case[0]),
                       key)
    print(f"[margin] {tag} {what}: {max(errs.values()):.4f} (must exceed "
          f"{PREFILL_TOL})")
    assert max(errs.values()) > PREFILL_TOL, errs
