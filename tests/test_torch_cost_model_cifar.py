"""The port's cost model == the reference's on the CifarNet cells of the
reference's sweep (tests/test_cost_model.py), exactly: ``model_cost`` ==
the port's live ledger == the reference's ledger, and the solver's path
labels and engines == the reference's under every deployment.  The helpers
and the MnistNet cells are in test_torch_cost_model.py."""
import pytest
import torch

from repro_torch.nn import bnn
from test_torch_cost_model import (MODE_IDS, assert_exact,
                                   assert_labels_match)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", range(4), ids=MODE_IDS)
@pytest.mark.parametrize("net", ["CifarNet1", "CifarNet2"])
def test_ledger_fidelity(net, mode):
    assert_exact(net, mode, (1,) + bnn.INPUT_SHAPES[net])


@pytest.mark.parametrize("mode", range(4), ids=MODE_IDS)
@pytest.mark.parametrize("net", ["CifarNet1", "CifarNet2"])
def test_solver_labels_match_reference(net, mode):
    assert_labels_match(net, mode)


def test_ledger_fidelity_cifarnet2_batch32():
    """The pinned batch-32 ledger of CifarNet2 (PERF.md §2)."""
    rep = assert_exact("CifarNet2", 0, (32,) + bnn.INPUT_SHAPES["CifarNet2"])
    assert (rep.rounds, rep.nbytes, rep.pre_rounds, rep.pre_nbytes) == \
        (33, 158_670_336, 48, 103_514_112)
