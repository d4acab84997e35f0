"""The control on the card, at the tiny configuration: the reference put
in the program's place with its matrix products in TF32, the precision
below the float32 the configurations state, fails at least one of each
cell kind's compared numbers against the limits of the real cells.  (On
the CPU there is no TF32, so the test needs the card: it carries the
repository's ``cuda`` marker and skips without one.)"""

import pytest
import torch

from benchmark.drivers import seq_eval as E, train_step as T
from benchmark.tests.conftest import tiny_cell


@pytest.fixture(scope="module")
def random_weights(tmp_path_factory):
    """The tiny network with seeded random weights, pose heads as drawn: its
    poses are far from identity, as the eval cells' are."""
    from efficientlo_net_torch.config import tiny_model_config
    from efficientlo_net_torch.models.pwclo import PWCLONet
    from efficientlo_net_torch.pretrained import save_pretrained, state_dict_to_variables

    torch.manual_seed(1)
    path = tmp_path_factory.mktemp("weights") / "random.msgpack"
    save_pretrained(str(path), state_dict_to_variables(PWCLONet(tiny_model_config()).state_dict()))
    return path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tf32_control_fails_a_train_limit(card, tiny_weights, seed):
    from benchmark import generate

    cell = tiny_cell("train", tiny_weights, batch_size=2, pool=3)
    batches = generate.train_batches(seed, cell.config["sensor"], cell.traffic, card)
    ref = T.reference_readings(cell, seed, batches, card)
    ctl = T.reference_readings(cell, seed, batches, card, tf32=True)
    readings = T.checks(ctl, ref)
    print(readings)
    assert any(readings[k] > limit for k, limit in cell.limits.items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tf32_control_fails_an_eval_limit(card, random_weights, seed):
    from benchmark import compare

    cell = tiny_cell("eval", random_weights, batch_size=8, check_frames=16)
    drive = E.make_drive(cell, seed, card)
    frames = E.check_frames(cell, seed)
    ref = E.reference_poses(cell, drive, frames, card)
    ctl = E.reference_poses(cell, drive, frames, card, tf32=True)
    readings = compare.pose_gaps(ctl, ref)
    print(readings)
    assert any(readings[k] > limit for k, limit in cell.limits.items()), readings
