"""The port's analysis passes (``repro_torch.analysis``): the contracts pass
over the port's exchange, graph and allocation registries, the trace
pass's double runs on the CPU, and the CLI's exit code.

Other test files may register throwaway entries in the registries, and
xdist may run them in this worker first: the checks below look at the
port's own classes (by source file), and every throwaway entry this file
registers is removed in a ``finally``.
"""
import json
import os
from pathlib import Path

import pytest
import torch

from repro.analysis.contracts import contracts_pass as jcontracts_pass
from repro.core import exchange as jexchange
from repro_torch.analysis import Report, run_analysis
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.contracts import CONTRACT_RULES, contracts_pass
from repro_torch.analysis.trace import trace_pass
from repro_torch.core import events, exchange, graph

PORT = str(Path(exchange.__file__).resolve().parents[1]) + os.sep  # src/repro_torch/
REFERENCE = str(Path(jexchange.__file__).resolve().parents[1]) + os.sep  # src/repro/


def _port_findings(findings):
    return [f for f in findings if f.path.startswith(PORT) or f.path.startswith("<")]


def test_port_registries_honor_their_contracts():
    findings, checks_run = contracts_pass()
    errors = [f for f in _port_findings(findings) if f.severity in ("warning", "error")]
    assert errors == [], "\n".join(f.render() for f in errors)
    assert checks_run > 150  # every entry x every clause
    assert CONTRACT_RULES == tuple(f"RC{i:03d}" for i in range(1, 14))


def test_port_and_reference_registries_give_the_same_findings():
    """The same rules over the two packages' registries: the same rules
    fire (the reference's RC012 info on ``static``, both registries), for
    classes of the same names."""
    def own(findings, package):
        return sorted((f.rule, f.severity, f.message) for f in findings
                      if f.path.startswith(package) or f.path.startswith("<"))

    port, _ = contracts_pass()
    ref, _ = jcontracts_pass()
    assert own(port, PORT) == own(ref, REFERENCE)


def _broken_protocol():
    @exchange.register_exchange("_broken_lossy_for_test")
    class BrokenLossy(exchange.ExchangeProtocol):
        lossy = True  # a lie: the default codec is exact and combine_ef is not overridden

        def combine(self, grads, ctx, *, generator=None, state=None):
            return grads, state

    return BrokenLossy


def test_contracts_catch_a_wrong_lossy_flag():
    cls = _broken_protocol()
    try:
        findings, _ = contracts_pass()
    finally:
        exchange._REGISTRY.pop("_broken_lossy_for_test", None)
    mine = [f for f in findings if "BrokenLossy" in f.message]
    assert {f.rule for f in mine} == {"RC003", "RC004"}, [f.render() for f in mine]
    assert all(f.path == __file__ and f.line > 0 for f in mine)
    assert "_broken_lossy_for_test" not in exchange.available_exchanges()
    assert cls.name == "_broken_lossy_for_test"


def test_contracts_report_an_entry_that_raises_instead_of_crashing():
    @graph.register_graph("_raising_for_test")
    class Raising(graph.PeerGraph):
        def __init__(self, num_peers, *, seed=0):
            raise RuntimeError("cannot build")

    @events.register_allocation("_greedy_for_test")
    class Greedy(events.AllocationPolicy):
        def memory_mb(self, *, epoch, planned_mb, history):
            return planned_mb + 64

    try:
        findings, _ = contracts_pass()
    finally:
        graph._REGISTRY.pop("_raising_for_test", None)
        events._ALLOC_REGISTRY.pop("_greedy_for_test", None)
    raising = [f for f in findings if f.message.startswith("Raising:")]
    assert len(raising) == 1 and "RuntimeError" in raising[0].message
    assert [f.rule for f in findings if f.message.startswith("Greedy:")] == ["RC011"]


def test_trace_pass_is_clean_on_the_cpu():
    findings, scenarios = trace_pass(device="cpu")
    assert scenarios == 2
    assert findings == [], "\n".join(f.render() for f in findings)


def test_run_analysis_merges_the_passes_and_refuses_unknown_ones():
    report = run_analysis(deep=False)
    assert isinstance(report, Report)
    assert sorted(report.passes_run) == ["contracts", "trace"]
    assert report.count("error") == 0 and not report.failed("warning")
    with pytest.raises(ValueError, match="unknown analysis pass"):
        run_analysis(passes=("contracts", "lint"))


def test_cli_exit_code(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert main(["--fast", "--json", str(out)]) == 0
    data = json.loads(out.read_text())
    assert sorted(data["passes"]) == ["contracts", "trace"]
    assert data["summary"]["error"] == 0
    _broken_protocol()
    try:
        assert main(["--passes", "contracts"]) == 1
        assert main(["--passes", "contracts", "--fail-on", "never"]) == 0
    finally:
        exchange._REGISTRY.pop("_broken_lossy_for_test", None)
    assert "RC003" in capsys.readouterr().out


def test_cluster_scenario_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_pass()
