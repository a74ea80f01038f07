"""Table 2's, Fig. 2's, Fig. 3's and Table 4's port ``run()`` at tiny
budgets on the CPU beside the reference's (``torch_paper_tiny.py`` says
what is checked; Table 3 and the frequency/error study are in
``test_torch_paper_tables.py``)."""

from __future__ import annotations

import pytest

import torch_threads  # noqa: F401  (caps torch's CPU threads)

import torch_paper_tiny


@pytest.mark.parametrize("name", ["table2_time", "fig2_fperm",
                                  "fig3_thresholds", "table4_combined"])
def test_run_at_tiny_budgets_gives_the_reference_rows(name, monkeypatch):
    torch_paper_tiny.check_run(name, monkeypatch)
