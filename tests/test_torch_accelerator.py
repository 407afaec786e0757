"""The port's ``TorchAccelerator`` against the reference's ``JaxAccelerator``,
on the CPU.

The same function, written once in ``jnp`` and once in torch, goes through
both accelerators over the same 20 numpy tasks: the results come back in
offload order with the same values, ``load_result`` after EOS and
``load_result_nb`` on an empty queue give ``(False, None)``, ``wait()``
returns 0, or -1 with ``error`` set when the function raises on the fifth
task, and ``offloaded`` counts the tasks.  On the card the accelerator is
held against synchronous calls in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FF_EOS as J_EOS
from repro.core import JaxAccelerator
from repro_torch.core import FF_EOS, TorchAccelerator

torch.set_num_threads(1)

TIMEOUT = 30.0      # seconds any one result or join may take


def _tasks(n=20):
    return [np.random.default_rng(i).standard_normal((16, 16))
            .astype(np.float32) for i in range(n)]


def _jfn(x):
    return (x @ x.T).sum(axis=1) * 0.5


def _tfn(x):
    return (x @ x.T).sum(dim=1) * 0.5


def _drain(acc, to_numpy):
    out = []
    while True:
        ok, r = acc.load_result(timeout=TIMEOUT)
        if not ok:
            assert r is None
            return out
        out.append(to_numpy(r))


@pytest.mark.parametrize("tuple_tasks", [False, True], ids=["bare", "tuple"])
def test_results_match_the_jax_accelerator_in_order(tuple_tasks):
    xs = _tasks()
    jacc = JaxAccelerator(jax.jit(_jfn), max_inflight=4)
    tacc = TorchAccelerator(_tfn, max_inflight=4, device="cpu")
    for acc, eos in ((jacc, J_EOS), (tacc, FF_EOS)):
        acc.run_then_freeze()
        assert acc.load_result_nb() == (False, None)    # nothing yet
        for x in xs:
            acc.offload((x,) if tuple_tasks else x)
        acc.offload(eos)
    want = _drain(jacc, np.asarray)
    got = _drain(tacc, lambda r: r.numpy())
    assert tacc.load_result_nb() == (False, None)       # past EOS
    assert jacc.wait(TIMEOUT) == 0 and tacc.wait(TIMEOUT) == 0
    assert not tacc._thread.is_alive() and tacc.error is None
    assert tacc.offloaded == jacc.offloaded == len(xs)
    assert tacc.ffTime() > 0
    assert len(got) == len(want) == len(xs)
    for g, w, x in zip(got, want, xs):
        assert g.dtype == w.dtype == np.float32
        # the two packages' float32 products sum in another order
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, (x @ x.T).sum(axis=1) * 0.5,
                                   rtol=1e-5, atol=1e-5)


def test_an_error_in_fn_ends_the_stream_and_wait_reports_it():
    def boom(fn):
        def f(x):
            if float(x[0, 0]) == 4.0:
                raise ValueError("fifth task")
            return fn(x)
        return f

    xs = [np.full((4, 4), i, np.float32) for i in range(5)]
    jacc = JaxAccelerator(boom(_jfn), max_inflight=8)
    tacc = TorchAccelerator(boom(_tfn), max_inflight=8, device="cpu")
    outs = []
    for acc, eos in ((jacc, J_EOS), (tacc, FF_EOS)):
        acc.run_then_freeze()
        for x in xs:
            acc.offload(x)
        acc.offload(eos)
        outs.append(_drain(acc, np.asarray))
        assert acc.wait(TIMEOUT) == -1
        assert isinstance(acc.error, ValueError)
        assert acc.offloaded == 5
    assert len(outs[0]) == len(outs[1]) == 4
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        assert TorchAccelerator(_tfn).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TorchAccelerator(_tfn)
    assert TorchAccelerator(_tfn, device="cpu").device.type == "cpu"


def test_tensor_and_pytree_tasks_reach_fn_as_tensors():
    acc = TorchAccelerator(lambda d, k: d["a"] * k + d["b"].float(),
                           device="cpu")
    acc.run_then_freeze()
    # numpy's 64-bit types narrow as jnp.asarray narrows them
    acc.offload(({"a": np.arange(3.0), "b": torch.tensor([1, 2, 3])}, 2))
    acc.offload(FF_EOS)
    ok, r = acc.load_result(timeout=TIMEOUT)
    assert ok and r.dtype == torch.float32
    assert r.tolist() == [1.0, 4.0, 7.0]
    assert acc.load_result(timeout=TIMEOUT) == (False, None)
    assert acc.wait(TIMEOUT) == 0


def test_the_offload_example_runs_on_the_cpu(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "accelerator_offload_torch.py"
    spec = importlib.util.spec_from_file_location("offload_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.demo_raw_accelerator("cpu") == 20
    assert mod.demo_serving("cpu") < 5 * 8
    assert "engine decode steps" in capsys.readouterr().out
