"""deepseek-v3's smoke config (MLA, a leading dense layer, 8 experts
top-2 and a shared one, the MTP head) through the port's
``make_hier_step`` against JAX's, on the CPU: 4 steps of DC in the
replicated regime and with ``param_mode="fsdp"`` (JAX's FSDP step on
``single_device_topology``), by
``tests/test_torch_moe_train.py``'s ``step_matches_jax``."""
import pytest
import torch

from test_torch_moe_train import step_matches_jax


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see tests/test_torch_lm_layers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_deepseek_steps_match_jax(mode):
    step_matches_jax("deepseek_v3_671b", mode)
