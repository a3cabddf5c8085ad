"""The dry run's ``build_combo`` on fake meshes, the MoE, MLA, Mamba and
xLSTM architectures: every step kind at smoke size on (2, 4) and
(2, 2, 2) (``check_build_combo`` in tests/test_torch_launch.py)."""
import pytest

from test_torch_launch import MESHES, check_build_combo, group  # noqa: F401

ARCHS = ["xlstm-1.3b", "deepseek-v2-236b", "deepseek-v3-671b",
         "jamba-1.5-large-398b"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_combo_runs_every_step_kind(group, arch,  # noqa: F811
                                          mesh_name):
    check_build_combo(group, arch, mesh_name)


def test_the_dry_run_files_cover_every_architecture():
    from repro_torch.configs import ARCH_IDS
    from test_torch_dryrun import ARCHS as DENSE
    assert sorted(DENSE + ARCHS) == sorted(ARCH_IDS)
