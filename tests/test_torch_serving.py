"""The port's serving engine against the reference's, on the CPU.

Both engines serve the reduced Mixtral-8x7B, the reduced Zamba2-1.2B (the
hybrid: Mamba2 layers and a shared attention block), the reduced
xLSTM-125m (mLSTM and sLSTM layers), the reduced Kimi-K2 at 32 experts
top-8 with a shared expert and the reduced Qwen2-VL at its 12/2 heads (text
prompts, as the reference's engine serves it), with the
reference's weights (carried across with ``core.params.from_numpy``) and
prompts from numpy seeds.  Greedy tokens must be equal
(``tests/test_serving.py:44``), and the port's engine must batch
continuously with results independent of the batch
(``tests/test_serving.py:60,85``).  The early-exit confidence is the
reference's bf16 ``max(softmax(logits))`` bit for bit, and the exit policy
fires as the reference's does (``tests/test_serving.py:226-264``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import FF_EOS as JFF_EOS
from repro.core.plan import single_device_plan as jplan
from repro.runtime.steps import init_state as jinit_state
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get as tget
from repro_torch.core import FF_EOS
from repro_torch.core.params import from_numpy
from repro_torch.core.plan import single_device_plan
from repro_torch.runtime.steps import (init_state, make_decode_step,
                                       make_prefill_step)
from repro_torch.serving import InferenceEngine, Overloaded, Request
from repro_torch.serving.engine import confidence

torch.set_num_threads(1)

ARCH = "mixtral-8x7b"
HYBRID = "zamba2-1.2b"
XLSTM = "xlstm-125m"
KIMI = "kimi-k2-1t-a32b"
# Kimi-K2's router at a width reduced() cuts away (E4 top-2)
KIMI_WIDE = {"n_experts": 32, "top_k": 8, "n_shared_experts": 1}
VLM = "qwen2-vl-2b"
# Qwen2-VL's 12 query heads over 2 KV heads (a GQA group of 6)
VLM_WIDE = {"n_heads": 12, "n_kv_heads": 2, "n_kv_eff": 2}
CACHE_LEN = 64


def _both(arch, **kw):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    for c in (jcfg, tcfg):
        for k, v in kw.items():
            setattr(c, k, v)
    params = jinit_state(jcfg, jplan(), jax.random.PRNGKey(0))["params"]
    tp = from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, single_device_plan("cpu"), tp


@pytest.fixture(scope="module")
def served():
    return _both(ARCH)


@pytest.fixture(scope="module")
def served_hybrid():
    return _both(HYBRID)


@pytest.fixture(scope="module")
def served_xlstm():
    return _both(XLSTM)


@pytest.fixture(scope="module")
def served_kimi():
    return _both(KIMI, **KIMI_WIDE)


@pytest.fixture(scope="module")
def served_vlm():
    return _both(VLM, **VLM_WIDE)


def _prompts(seed, n, lengths=(8,)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, lengths[i % len(lengths)], dtype=np.int32)
            for i in range(n)]


def _serve(eng, request_cls, prompts, max_new, eos=FF_EOS):
    """Offload every prompt through the paper's API, drain, and return the
    finished requests by id."""
    eng.run_then_freeze()
    for i, p in enumerate(prompts):
        n = max_new[i] if isinstance(max_new, list) else max_new
        eng.offload(request_cls(prompt=p, max_new_tokens=n, id=i))
    eng.offload(eos)
    got = {}
    while True:
        ok, req = eng.load_result()
        if not ok:
            break
        got[req.id] = req
    assert eng.wait() == 0
    return got


def _manual_greedy(cfg, plan, params, prompt, n_new):
    prefill = make_prefill_step(cfg, plan, CACHE_LEN)
    decode = make_decode_step(cfg, plan, CACHE_LEN)
    logits, caches = prefill(params,
                             {"tokens": torch.from_numpy(prompt)[None]})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [int(tok[0, 0])]
    for i in range(n_new - 1):
        tok, _, caches = decode(params, caches,
                                {"token": tok,
                                 "pos": torch.tensor(len(prompt) + i,
                                                     dtype=torch.int32)})
        out.append(int(tok[0, 0]))
    return out


def test_engine_tokens_equal_the_reference_engine(served):
    jcfg, jparams, tcfg, plan, tp = served
    # ragged prompts; 40 outgrows the reduced config's 32-token window
    prompts = _prompts(0, 3, lengths=(8, 21, 40))
    want = _serve(JEngine(jcfg, jplan(), jparams, max_batch=2,
                          cache_len=CACHE_LEN), JRequest, prompts, 6,
                  eos=JFF_EOS)
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 6)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in range(3):
        assert got[i].tokens == want[i].tokens, i
        assert got[i].finish_reason == want[i].finish_reason == "max_tokens"


def test_hybrid_engine_tokens_equal_the_reference_engine(served_hybrid):
    """Zamba2 with prompts the reference's ``chunked_gla`` takes (shorter
    than, or a multiple of, ``gla_chunk`` 16); 48 outgrows the reduced
    32-token window, so the shared block decodes on the ring."""
    jcfg, jparams, tcfg, plan, tp = served_hybrid
    prompts = _prompts(5, 4, lengths=(7, 16, 32, 48))
    want = _serve(JEngine(jcfg, jplan(), jparams, max_batch=2,
                          cache_len=CACHE_LEN), JRequest, prompts, 6,
                  eos=JFF_EOS)
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 6)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in range(4):
        assert got[i].tokens == want[i].tokens, i
        assert got[i].finish_reason == want[i].finish_reason == "max_tokens"


def test_hybrid_engine_matches_its_manual_loop_on_ragged_prompts(
        served_hybrid):
    """Prompt lengths the reference cannot prefill (not a multiple of the
    chunk): the engine's tokens equal a prefill + decode loop, whatever the
    batch they share."""
    _, _, tcfg, plan, tp = served_hybrid
    prompts = _prompts(6, 3, lengths=(21, 40, 9))
    want = [_manual_greedy(tcfg, plan, tp, p, 5) for p in prompts]
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 5)
    for i in range(3):
        assert got[i].tokens == want[i], i


def test_hybrid_batch_state_holds_the_recurrent_state(served_hybrid):
    """The engine's batched state takes the fp32 ``ssm`` leaf and the
    shared block's per-call KV stack, and the slot insert writes a
    prefilled request into one slot only."""
    from repro_torch.serving.engine import _BatchState, _insert
    _, _, tcfg, plan, tp = served_hybrid
    st = _BatchState(tcfg, 3, CACHE_LEN, plan.device)
    n_mamba = sum(c for k, c in tcfg.segments if k == "mamba2")
    n_shared = sum(c for k, c in tcfg.segments if k == "shared_attn")
    assert st.caches["mamba2"]["ssm"].dtype == torch.float32
    assert st.caches["mamba2"]["ssm"].shape[:2] == (n_mamba, 3)
    assert st.caches["shared_attn"]["k"].shape[:2] == (n_shared, 3)
    prefill = make_prefill_step(tcfg, plan, CACHE_LEN)
    _, cache1 = prefill(tp, {"tokens": torch.from_numpy(
        _prompts(7, 1, lengths=(13,))[0])[None]})
    _insert(st, cache1, 1, torch.tensor([[5]], dtype=torch.int32), 13)
    for kind, leaves in cache1.items():
        for n, c in leaves.items():
            assert torch.equal(st.caches[kind][n][:, 1], c[:, 0])
            assert not st.caches[kind][n][:, 0].any()
    assert st.pos.tolist() == [0, 13, 0] and st.cur_tok[1, 0] == 5


def test_xlstm_engine_tokens_equal_the_reference_engine(served_xlstm):
    """xLSTM: every request's greedy tokens equal the reference engine's,
    on prompts the reference's ``chunked_gla`` takes (shorter than, or a
    multiple of, ``gla_chunk`` 16), and request 0's equal the manual
    prefill + decode loop."""
    jcfg, jparams, tcfg, plan, tp = served_xlstm
    prompts = _prompts(8, 3, lengths=(16, 7, 32))
    want = _serve(JEngine(jcfg, jplan(), jparams, max_batch=2,
                          cache_len=CACHE_LEN), JRequest, prompts, 6,
                  eos=JFF_EOS)
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 6)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in range(3):
        assert got[i].tokens == want[i].tokens, i
    assert got[0].tokens == _manual_greedy(tcfg, plan, tp, prompts[0], 6)


def test_xlstm_batch_state_holds_the_recurrent_state(served_xlstm):
    """The batched state takes the mLSTM's fp32 ``C`` and ``n`` and bf16
    ``conv``, and the sLSTM's fp32 ``c`` and ``n``; the slot insert writes
    a prefilled request into one slot only, and the engine's tokens on
    ragged prompts equal the manual loop's."""
    from repro_torch.serving.engine import _BatchState, _insert
    _, _, tcfg, plan, tp = served_xlstm
    st = _BatchState(tcfg, 3, CACHE_LEN, plan.device)
    mC, mn = st.caches["mlstm"]["C"], st.caches["mlstm"]["n"]
    P = 2 * tcfg.d_model // tcfg.n_heads
    assert mC.dtype == mn.dtype == torch.float32
    assert tuple(mC.shape) == (2, 3, tcfg.n_heads, P, P)
    assert tuple(mn.shape) == (2, 3, tcfg.n_heads, P, 1)
    assert st.caches["mlstm"]["conv"].dtype == torch.bfloat16
    assert tuple(st.caches["slstm"]["c"].shape) == (1, 3, tcfg.d_model)
    prefill = make_prefill_step(tcfg, plan, CACHE_LEN)
    _, cache1 = prefill(tp, {"tokens": torch.from_numpy(
        _prompts(9, 1, lengths=(13,))[0])[None]})
    _insert(st, cache1, 2, torch.tensor([[7]], dtype=torch.int32), 13)
    for kind, leaves in cache1.items():
        for n, c in leaves.items():
            assert torch.equal(st.caches[kind][n][:, 2], c[:, 0])
            assert not st.caches[kind][n][:, :2].any()
    assert st.pos.tolist() == [0, 0, 13] and st.cur_tok[2, 0] == 7
    prompts = _prompts(10, 3, lengths=(21, 9, 40))
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 5)
    for i in range(3):
        assert got[i].tokens == _manual_greedy(tcfg, plan, tp, prompts[i],
                                               5), i


def test_kimi_engine_tokens_equal_the_reference_engine(served_kimi):
    """Kimi-K2 at E32 top-8 with a shared expert: the router on every
    prefill and decode step; every request's tokens equal the reference
    engine's and request 0's the manual loop's."""
    jcfg, jparams, tcfg, plan, tp = served_kimi
    prompts = _prompts(11, 3, lengths=(8, 21, 40))
    want = _serve(JEngine(jcfg, jplan(), jparams, max_batch=2,
                          cache_len=CACHE_LEN), JRequest, prompts, 6,
                  eos=JFF_EOS)
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 6)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in range(3):
        assert got[i].tokens == want[i].tokens, i
    assert got[0].tokens == _manual_greedy(tcfg, plan, tp, prompts[0], 6)


def test_vlm_engine_tokens_equal_the_reference_engine(served_vlm):
    """Qwen2-VL at 12/2 heads, text prompts through both engines (RoPE on
    the sequence index: the engine passes tokens only, as the reference's
    does); every request's tokens equal the reference engine's and request
    0's the manual loop's."""
    jcfg, jparams, tcfg, plan, tp = served_vlm
    prompts = _prompts(13, 3, lengths=(8, 21, 40))
    want = _serve(JEngine(jcfg, jplan(), jparams, max_batch=2,
                          cache_len=CACHE_LEN), JRequest, prompts, 6,
                  eos=JFF_EOS)
    got = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                 cache_len=CACHE_LEN), Request, prompts, 6)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in range(3):
        assert got[i].tokens == want[i].tokens, i
    assert got[0].tokens == _manual_greedy(tcfg, plan, tp, prompts[0], 6)


def test_engine_matches_its_manual_loop(served):
    _, _, tcfg, plan, tp = served
    prompt = _prompts(1, 1)[0]
    want = _manual_greedy(tcfg, plan, tp, prompt, 6)
    with InferenceEngine(tcfg, plan, tp, max_batch=2,
                         cache_len=CACHE_LEN) as eng:
        out = eng.submit(Request(prompt=prompt, max_new_tokens=6)
                         ).result(timeout=120)
    assert isinstance(out, Request) and out.tokens == want


def test_engine_continuous_batching_many_requests(served):
    _, _, tcfg, plan, tp = served
    N = 7
    max_new = [4 + (i % 3) for i in range(N)]
    eng = InferenceEngine(tcfg, plan, tp, max_batch=3, cache_len=CACHE_LEN)
    done = _serve(eng, Request, _prompts(2, N), max_new)
    assert sorted(done) == list(range(N))
    for i, r in done.items():
        assert len(r.tokens) == max_new[i]
    # batched slots: fewer decode steps than the sequential sum of lengths
    assert eng.steps < sum(max_new)
    assert eng.stats()["requests"]["finished"] == N


def test_engine_results_independent_of_batching(served):
    _, _, tcfg, plan, tp = served
    prompts = _prompts(3, 3)
    solo = [_serve(InferenceEngine(tcfg, plan, tp, max_batch=3,
                                   cache_len=CACHE_LEN), Request, [p], 5)[0]
            for p in prompts]
    packed = _serve(InferenceEngine(tcfg, plan, tp, max_batch=3,
                                    cache_len=CACHE_LEN), Request, prompts, 5)
    for i in range(3):
        assert packed[i].tokens == solo[i].tokens, i


def test_submit_sheds_past_max_pending(served):
    _, _, tcfg, plan, tp = served
    with InferenceEngine(tcfg, plan, tp, max_batch=1, cache_len=CACHE_LEN,
                         max_pending=2) as eng:
        handles = [eng.submit(Request(prompt=p, max_new_tokens=2))
                   for p in _prompts(4, 6)]
        outs = [h.result(timeout=120) for h in handles]
    assert any(isinstance(o, Overloaded) for o in outs)
    assert all(len(o.tokens) == 2 for o in outs if isinstance(o, Request))


def test_engine_defaults_to_cuda_and_refuses_adaptive(served):
    _, _, tcfg, plan, tp = served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            InferenceEngine(tcfg, None, tp)
    eng = InferenceEngine(tcfg, None, tp, device="cpu", cache_len=CACHE_LEN)
    assert eng.plan.device == torch.device("cpu")
    # adaptive=True is ported: a Supervisor rides along, the engine serves
    # the same tokens, and stopping the Supervisor twice is a no-op (as
    # tests/test_serving.py::test_adaptive_engine_supervisor_stop_idempotent)
    prompt = _prompts(11, 1)[0]
    solo = _serve(InferenceEngine(tcfg, plan, tp, max_batch=2,
                                  cache_len=CACHE_LEN), Request, [prompt],
                  3)[0]
    eng = InferenceEngine(tcfg, plan, tp, max_batch=2, cache_len=CACHE_LEN,
                          adaptive=True)
    with eng:
        out = eng.submit(Request(prompt=prompt, max_new_tokens=3)).result(
            timeout=300)
    assert out.done and out.tokens == solo.tokens
    assert eng.stats()["supervisor"]["ticks"] >= 0
    assert isinstance(eng.replacement_events(), list)
    eng.supervisor.stop()
    assert eng.wait(timeout=10) == 0
    with pytest.raises(ValueError, match="params on"):
        InferenceEngine(tcfg, single_device_plan("meta"), tp)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                       "--max-new", "3", "--max-batch", "2",
                       "--layers", "1"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests, 9 tokens" in out
    assert "engine graph on cpu" in out


def test_serve_launcher_takes_adaptive_and_tuned(capsys, monkeypatch):
    """``--adaptive`` serves under the Supervisor and reports its events;
    ``--tuned`` re-execs once, so with the re-exec's guard set (as in the
    re-exec'd child) it runs on in this process."""
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_TUNED", "1")
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                       "--max-new", "3", "--max-batch", "2", "--layers",
                       "1", "--adaptive", "--tuned"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests, 9 tokens" in out
    assert "re-placement events:" in out and "(supervisor {" in out


def test_serve_launcher_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--arch", HYBRID, "--requests",
                       "2", "--max-new", "3", "--max-batch", "2",
                       "--prompt-len", "21"]) == 0
    assert "served 2/2 requests, 6 tokens" in capsys.readouterr().out


def test_serve_launcher_refuses_layers_for_a_segmented_config(capsys):
    """``--layers`` sets ``n_layers``, which a config with a segment list
    (Zamba2) does not read: the launcher says so instead of ignoring it."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", HYBRID, "--layers", "1"])
    assert "segment" in capsys.readouterr().err


def test_serve_launcher_runs_xlstm_and_refuses_its_layers(capsys):
    """The reduced xLSTM serves here; ``--layers`` is refused for it, as
    for Zamba2: its depth is its segment list."""
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--arch", XLSTM, "--requests",
                       "2", "--max-new", "3", "--max-batch", "2",
                       "--prompt-len", "21"]) == 0
    assert "served 2/2 requests, 6 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", XLSTM, "--layers", "2"])
    assert "segment" in capsys.readouterr().err


def test_serve_launcher_runs_qwen2_vl_and_refuses_whisper(capsys):
    """Qwen2-VL serves text prompts here, as the reference's launcher serves
    it; Whisper, whose prefill also takes frames, is refused with the steps
    that run it."""
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--arch", VLM, "--requests", "2",
                       "--max-new", "3", "--max-batch", "2"]) == 0
    assert "served 2/2 requests, 6 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "whisper-medium"])
    assert "make_prefill_step" in capsys.readouterr().err


def test_init_state_draws_on_the_plan_device(served):
    _, _, tcfg, plan, _ = served
    a = init_state(tcfg, plan, torch.Generator().manual_seed(3))["params"]
    b = init_state(tcfg, plan, torch.Generator().manual_seed(3))["params"]
    assert torch.equal(a["embed"]["emb"], b["embed"]["emb"])
    assert a["embed"]["emb"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="generator on"):
        init_state(tcfg, single_device_plan("meta"),
                   torch.Generator().manual_seed(3))


# -- early exit (tests/test_serving.py:226-264) ---------------------------------
_jconf = jax.jit(lambda x: jnp.max(jax.nn.softmax(x[:, -1, :], axis=-1), -1))


def _conf32(logits):
    """The confidence in fp32, as the port computed it before it followed
    the reference's bf16 rounding."""
    return torch.softmax(logits[:, -1, :].float(), dim=-1).amax(-1)


@pytest.mark.parametrize("B,V,scale,seed", [(2, 4096, 3.0, 0),
                                            (8, 32000, 3.0, 1),
                                            (8, 32000, 8.0, 2),
                                            (4, 32000, 1.0, 3),
                                            (8, 4096, 20.0, 4),
                                            (8, 50257, 3.0, 5)])
def test_confidence_equals_the_reference_bit_for_bit(B, V, scale, seed):
    """``confidence`` on bf16 logits equals the reference engine's jitted
    ``jnp.max(jax.nn.softmax(logits[:, -1, :]))`` exactly (vocab 32000 is
    Mixtral's and Zamba2's); the fp32 softmax it replaced does not."""
    a = (np.random.default_rng(seed).standard_normal((B, 1, V))
         * scale).astype(np.float32)
    want = np.asarray(_jconf(jnp.asarray(a).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    t = torch.from_numpy(a).to(torch.bfloat16)
    got = confidence(t)
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(_conf32(t).numpy(), want)
    if (B, V, seed) == (2, 4096, 0):     # bf16 values, exact in float32
        assert want.tolist() == [0.08056640625, 0.052734375]


def test_early_exit_fires_and_caps_decode(served):
    """With a threshold below the model's observed confidence the request
    stops early; with an impossible threshold it runs to max_new_tokens."""
    _, _, tcfg, plan, tp = served
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab, 6,
                                               dtype=np.int32)
    with InferenceEngine(tcfg, plan, tp, max_batch=1,
                         cache_len=CACHE_LEN) as eng:
        eng.submit(Request(prompt=prompt, max_new_tokens=3)).result(300)
        conf = float(eng.state.last_conf[0])
    assert 0.0 < conf < 1.0
    with InferenceEngine(tcfg, plan, tp, max_batch=1, cache_len=CACHE_LEN,
                         exit_threshold=conf * 0.5) as eng:
        out = eng.submit(Request(prompt=prompt,
                                 max_new_tokens=50)).result(300)
    assert out.finish_reason == "early_exit"
    assert len(out.tokens) < 50 and eng.early_exits == 1
    with InferenceEngine(tcfg, plan, tp, max_batch=1, cache_len=CACHE_LEN,
                         exit_threshold=2.0) as eng:    # unreachable
        out = eng.submit(Request(prompt=prompt,
                                 max_new_tokens=4)).result(300)
    assert out.finish_reason == "max_tokens" and len(out.tokens) == 4


def test_per_request_exit_threshold_overrides_engine(served):
    _, _, tcfg, plan, tp = served
    prompt = np.random.default_rng(10).integers(0, tcfg.vocab, 6,
                                                dtype=np.int32)
    with InferenceEngine(tcfg, plan, tp, max_batch=1, cache_len=CACHE_LEN,
                         exit_threshold=2.0) as eng:
        # the request relaxes the engine's unreachable threshold: any
        # confidence exits on the first decode turn
        out = eng.submit(Request(prompt=prompt, max_new_tokens=50,
                                 exit_threshold=1e-9)).result(300)
    assert out.finish_reason == "early_exit" and len(out.tokens) == 2


def test_engine_exit_follows_the_bf16_confidence(served):
    """A threshold between the fp32 and the bf16 confidence of the first
    decode turn: the engine decides as the bf16 confidence, which equals
    the reference's on the same logits, says."""
    _, _, tcfg, plan, tp = served
    prompt = np.random.default_rng(11).integers(0, tcfg.vocab, 6,
                                                dtype=np.int32)
    prefill = make_prefill_step(tcfg, plan, CACHE_LEN)
    decode = make_decode_step(tcfg, plan, CACHE_LEN)
    logits, caches = prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    _, logits, _ = decode(tp, caches, {"token": tok, "pos": torch.tensor(
        len(prompt), dtype=torch.int32)})
    assert logits.dtype == torch.bfloat16
    c16, c32 = float(confidence(logits)[0]), float(_conf32(logits)[0])
    assert c16 == float(np.asarray(_jconf(jnp.asarray(
        logits.float().numpy()).astype(jnp.bfloat16)))[0])
    assert c16 != c32
    thr = (c16 + c32) / 2
    with InferenceEngine(tcfg, plan, tp, max_batch=1, cache_len=CACHE_LEN,
                         exit_threshold=thr) as eng:
        out = eng.submit(Request(prompt=prompt,
                                 max_new_tokens=4)).result(300)
    first_turn_exit = out.finish_reason == "early_exit" and \
        len(out.tokens) == 2
    assert first_turn_exit == (c16 >= thr)
