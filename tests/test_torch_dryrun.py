"""The dry run's ``build_combo`` on fake meshes, the attention-with-dense-FFN
architectures: every step kind at smoke size on (2, 4) and (2, 2, 2)
(``check_build_combo`` in tests/test_torch_launch.py; the MoE, Mamba and
xLSTM architectures are in tests/test_torch_dryrun_moe.py)."""
import pytest

from test_torch_launch import MESHES, check_build_combo, group  # noqa: F401

ARCHS = ["smollm-135m", "qwen2-0.5b", "deepseek-7b", "phi3-mini-3.8b",
         "llava-next-34b", "seamless-m4t-medium"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_combo_runs_every_step_kind(group, arch,  # noqa: F811
                                          mesh_name):
    check_build_combo(group, arch, mesh_name)
