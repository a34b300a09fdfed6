"""The port's plan inspector (``python -m repro_torch.plan``) against the
reference's (``python -m repro.plan``), on the CPU.

For each argument set both inspectors run in this process with their
output captured: the plan section (stage schedule, exec groups, liveness
peak) must be the same text, and the cost verdict (backend, dtype, bytes
per coloring, fusion slack, picked chunk) the same numbers, with the
reference's fusion slack pinned to 1.0, the port's on the CPU.  Only the
wording of the backend heuristic's reason may differ.  ``--mesh-shards``
prints the mesh comm model's verdict, equal to the reference's.
"""

import contextlib
import io

import pytest
import torch

import repro.plan.cost as ref_cost
from repro.plan.__main__ import main as ref_main

from repro_torch.core import templates as port_templates
from repro_torch.plan import cost
from repro_torch.plan.__main__ import main as port_main
from repro_torch.plan.ir import build_template_plan

CASES = {
    "u6": ["u6"],
    "four-trees": ["path6", "star6", "bintree6", "u6"],
    "u7-rmat": ["u7", "--graph", "rmat:2048:20000:1"],
    "triangle+square-er": ["--template", "triangle", "--template", "square", "--graph", "er:500:2000"],
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setenv(cost.BENCH_ENV_VAR, str(tmp_path / "memory.json"))
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)


def _run(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_inspector_prints_the_reference_plan_and_cost(case):
    argv = CASES[case]
    want = _run(ref_main, argv)
    got = _run(port_main, argv + ["--device", "cpu"])
    assert len(got) == len(want)
    verdicts = 0
    for g, w in zip(got, want):
        if w.startswith("  backend: "):
            # the backend name; the heuristic's reason is worded differently
            assert g.split(" (")[0] == w.split(" (")[0]
            verdicts += 1
        else:
            assert g == w
    assert verdicts == ("--graph" in argv) * len([line for line in want if line.startswith("TemplatePlan")])
    if "--graph" in argv:
        assert any("fusion slack 1.0000" in line for line in got)


@pytest.mark.parametrize("shards", [1, 4])
def test_inspector_mesh_shards_waits_for_the_mesh_slice(shards):
    """The mesh slice is ported: ``--mesh-shards`` prints the comm model's
    per-stage verdict, line for line the reference's (and, like the
    reference's, needs ``--graph``)."""
    argv = ["u6", "--graph", "rmat:300:1500:2", "--mesh-shards", str(shards)]
    want = _run(ref_main, argv)
    got = _run(port_main, argv + ["--device", "cpu"])
    start = want.index(next(line for line in want if line.startswith("Mesh comm schedule")))
    assert got[start - 1:] == want[start - 1:]
    assert len(want) - start == 2 + len(build_template_plan([port_templates.get_template("u6")])
                                         .exec_groups)
    with pytest.raises(SystemExit):
        _run(port_main, ["u6", "--mesh-shards", "4", "--device", "cpu"])


def test_inspector_runs_on_the_card_unless_told_otherwise():
    """The cost verdict binds an engine on the CUDA card by default; without
    one it raises instead of running on the CPU (the plan section needs no
    device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    assert _run(port_main, ["u5-1"])[0].startswith("TemplatePlan: [u5-1]")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(port_main, ["u5-1", "--graph", "rmat:300:1500:2"])
    with pytest.raises(SystemExit):
        port_main(["u5-1", "--graph", "rmat:300"])
