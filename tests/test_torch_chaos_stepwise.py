"""The chaos harness's ``run_one`` row under the stepwise scheduler, port
against reference (the other schedulers' rows and the rest of the harness:
``test_torch_chaos.py``; the reference compiles its stepwise executor
anew, so this row has a file of its own)."""
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_chaos import check_row, graphs  # noqa: F401  (fixture)


def test_run_one_row_matches_the_reference_stepwise(graphs, monkeypatch):  # noqa: F811
    check_row(graphs, "sync_stepwise", monkeypatch)
