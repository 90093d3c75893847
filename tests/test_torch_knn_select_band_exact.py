"""Kernel F's band filter in the exact order: the exact half of the margin
sweep of `tests/test_torch_knn_select_band.py` (which has the emulation,
the inputs and the packed half), in a file of its own so that a test run
that gives each file one worker spreads the sweep over two.
"""

import pytest
import torch

from test_torch_knn_select_band import HARD_BAND, check_margin

torch.set_num_threads(2)   # six test workers share the host's cores


class TestBandFilterRule:
    @pytest.mark.parametrize("mode", ["exact"])
    @pytest.mark.parametrize("name", HARD_BAND)
    def test_margin_keeps_every_neighbour(self, name, mode):
        check_margin(name, mode)
