"""Each of the port's dataset drivers refuses to run without a card when the
caller leaves ``--device`` at its default, the card, and writes no
trajectory (the drivers' runs on the CPU are in test_torch_drivers.py).
"""
import os

import pytest
import torch

from test_io_drivers import SETTINGS_YAML
from test_torch_drivers import DRIVERS, _outputs


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_a_driver_without_a_card_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    module, n_positional = DRIVERS[name]
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS_YAML)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([str(settings), *[str(tmp_path)] * n_positional,
                     *_outputs(tmp_path, name)])
    assert not os.path.exists(tmp_path / f"{name}.txt")
