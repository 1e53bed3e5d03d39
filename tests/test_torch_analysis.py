"""Port: the repo's static invariant checks over the port's files.

``tools/analysis/run.py --strict`` walks ``fast_tffm_tpu/``, ``tools/`` and
the JAX drivers (``core.discover``); the port's package, ``bench_torch.py``,
``bench_all_torch.py`` and ``chip_smoke.py`` are outside it.  This test runs
the suite's stdlib rules that apply to torch code (locks, exceptions,
blocking, lifecycle, publish, telemetry, collectives) over those files
through ``core.RepoContext`` and ``run.run_suite``, and holds the findings
to the baseline pinned below, each with its reason: a new finding fails,
and so does a pin that no longer matches a finding.  ``donation`` and
``recompile`` check JAX programs and have no counterpart here; ``config``
and ``formats`` check the JAX package's registries.
"""

import os

import pytest

from tools.analysis import core
from tools.analysis.run import run_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("locks", "exceptions", "blocking", "lifecycle", "publish", "telemetry", "collectives")
DRIVERS = ("bench_torch.py", "bench_all_torch.py", "chip_smoke.py")

BASELINE = {
    "atomic-publish::fast_tffm_tpu_torch/ops/kernel_build.py::<module>:no-tmp-write:tmp": (
        "a false positive: the tmp file is nvcc's output (`-o tmp` in the command this "
        "scope starts); build() renames it into place only after nvcc exits 0, and its "
        "finally removes it on any failure"),
    "blocking-under-lock::fast_tffm_tpu_torch/serving/replica.py::"
    "_Conn.send_bytes:sendall:_Conn._wlock": (
        "the JAX replica's twin (fast_tffm_tpu/serving/replica.py:93, suppressed there): "
        "the peer is the router, which reads eagerly on its own thread; a wedged router is "
        "killed or closes the socket, which unblocks sendall with OSError, and a socket "
        "timeout would also bound the reader loop sharing this socket"),
    "exception-hygiene::fast_tffm_tpu_torch/resilience.py::"
    "repair_delta_chain:swallow:Exception": (
        "the JAX twin (fast_tffm_tpu/resilience.py:561, suppressed there): any unreadable "
        "base is nothing a tail repair can fix, and the strict restore reports it loudly"),
    "exception-hygiene::fast_tffm_tpu_torch/resilience.py::Supervisor._tail:swallow:Exception": (
        "the JAX twin (fast_tffm_tpu/resilience.py:721, suppressed there): an owner-injected "
        "progress callback; the tail thread must outlive any callback bug, and the MTTR is "
        "already stamped"),
}


def _port_files() -> list[str]:
    rels = list(DRIVERS)
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, "fast_tffm_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in core.DEFAULT_EXCLUDE_DIRS]
        rels += [os.path.relpath(os.path.join(dirpath, f), REPO)
                 for f in filenames if f.endswith(".py")]
    return rels


@pytest.fixture(scope="module")
def findings():
    rels = _port_files()
    ctx = core.RepoContext(REPO, rels)
    assert not ctx.parse_findings, [f.render() for f in ctx.parse_findings]
    assert len(ctx.files) == len(rels) >= 60
    found, _ = run_suite(REPO, list(RULES), ctx=ctx)
    return {f.key: f for f in found}


def test_no_finding_outside_the_baseline(findings):
    new = {k: f.render() for k, f in findings.items() if k not in BASELINE}
    assert not new, new


def test_every_pin_still_matches_a_finding_and_has_a_reason(findings):
    assert set(BASELINE) <= set(findings), sorted(set(BASELINE) - set(findings))
    assert all(len(reason.split()) >= 8 for reason in BASELINE.values())


def test_the_rules_fire_on_the_port(tmp_path):
    """The same run finds a torn publish (chip_smoke's serving sweep before
    it went through ``write_json_artifact``) and a send under a lock with
    no deadline in a port-shaped file: the rules are live on these paths."""
    pkg = tmp_path / "fast_tffm_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        "import json\n"
        "import os\n"
        "import threading\n"
        "\n"
        "OUT = 'out'\n"
        "\n"
        "\n"
        "def publish(obj):\n"
        "    with open(os.path.join(OUT, 'SWEEP.json'), 'w') as f:\n"
        "        json.dump(obj, f)\n"
        "\n"
        "\n"
        "class Conn:\n"
        "    def __init__(self, sock):\n"
        "        self._sock = sock\n"
        "        self._wlock = threading.Lock()\n"
        "\n"
        "    def send(self, data):\n"
        "        with self._wlock:\n"
        "            self._sock.sendall(data)\n"
    )
    ctx = core.RepoContext(str(tmp_path), ["fast_tffm_tpu_torch/bad.py"])
    found, _ = run_suite(str(tmp_path), list(RULES), ctx=ctx)
    assert {f.rule for f in found} == {"blocking-under-lock", "atomic-publish"}, [
        f.render() for f in found]
