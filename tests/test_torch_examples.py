"""The example twins (``examples/*_torch.py``) run with ``--device cpu`` and
print what their originals print.

* ``sieve_pipeline_torch.py``: the same messages as ``sieve_pipeline.py``
  (both run here), but the pipe time, in any order (the stages are
  threads that print as they end);
* ``quickstart_torch.py``: the same parameter count, steps and restarts
  as ``quickstart.py`` (both run here at a small batch), its first loss
  within 5% of the original's (the packages draw their weights from
  different generators: ff-tiny's first loss is ~ln(4096) = 8.3 either
  way) and its last loss below its first;
* ``map_matmul_torch.py``: the four checks ``map_matmul.py`` prints, each
  passed (the twin's assertions hold the products within 1e-5).
"""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_sieve_twin_prints_what_the_original_prints():
    got = _run("sieve_pipeline_torch.py", "5", "40", "--device", "cpu")
    want = _run("sieve_pipeline.py", "5", "40")

    def messages(out):
        # stages print from their threads, so one message's newline may
        # land after another's text: each message, wherever it sits
        return sorted(re.findall(
            r"\[host  \] seq\(\w+\)|Prime\(\d+\)|Printer started|Sieve "
            r"started\. Generating a stream of \d+ elements, starting with 2|"
            r"Sieve terminating, prime numbers found up to \d+", out))
    assert messages(got) == messages(want)
    assert len(messages(got)) == 7 + 5 + 3   # stages, primes, lifecycle
    assert "Prime(11)" in got and "prime numbers found up to 13" in got
    assert re.search(r"DONE, pipe time = [\d.]+ \(ms\)", got)


def _quickstart(out):
    m = re.search(r"arch=(\S+) params=([\d.]+)M", out)
    d = re.search(r"done: steps=(\d+) loss ([\d.]+) -> ([\d.]+) "
                  r"\(restarts=(\d+)\)", out)
    assert m and d, out
    return (m.group(1), m.group(2), int(d.group(1)), float(d.group(2)),
            float(d.group(3)), int(d.group(4)))


def test_quickstart_twin_prints_what_the_original_prints():
    args = ("--steps", "6", "--batch", "2", "--seq", "32")
    got = _quickstart(_run("quickstart_torch.py", *args, "--device", "cpu"))
    want = _quickstart(_run("quickstart.py", *args))
    assert got[:3] == want[:3]                  # arch, params, steps
    assert got[5] == want[5] == 0               # restarts
    assert abs(got[3] - want[3]) <= 0.05 * want[3]
    assert got[4] < got[3]


def test_map_matmul_twin_passes_the_originals_checks():
    got = _run("map_matmul_torch.py", "--device", "cpu")
    heads = re.findall(r'print\("([^:"]+):',
                       (ROOT / "examples" / "map_matmul.py").read_text())
    assert len(heads) == 4
    printed = [line.split(":")[0] for line in got.splitlines()]
    assert printed == heads
    assert got.count(": OK") == 2 and got.count("parity") == 2
