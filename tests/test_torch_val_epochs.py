"""``Trainer.run`` validates at the JAX trainer's epochs: an interval that
does not divide the epochs, and a run resumed at epoch 4
(``tests/test_torch_val.py``'s check)."""
import pytest

from tests.test_torch_val import VAL_SCHEDULES, check_run_validates


@pytest.mark.parametrize("max_epochs,interval,start", VAL_SCHEDULES[3:])
def test_run_validates_at_the_reference_epochs(max_epochs, interval, start):
    check_run_validates(max_epochs, interval, start)
