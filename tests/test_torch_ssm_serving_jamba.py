"""jamba's cases of tests/test_torch_ssm_serving.py, under the same test
names: the tests and their contract are that file's (one period of 8
layers; 16 for the checkpoint). They sit in a file of their own because
they are its heaviest, and pytest-xdist's ``--dist loadfile`` gives each
file to one worker.
"""
import pytest

pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)
import test_torch_ssm_serving as S  # noqa: E402
from test_torch_ssm_serving import reference_norms  # noqa: E402,F401

NAMES = (S.JAMBA,)


@pytest.mark.parametrize("mode", S.MODES)
@pytest.mark.parametrize("name", NAMES)
def test_pool_matches_reference(name, mode, reference_norms):  # noqa: F811
    S.test_pool_matches_reference(name, mode, reference_norms)


@pytest.mark.parametrize("mode", S.MODES)
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(name, mode, reference_norms,  # noqa: F811
                                    monkeypatch):
    S.test_generate_matches_reference(name, mode, reference_norms,
                                      monkeypatch)


@pytest.mark.parametrize("mode", S.MODES)
@pytest.mark.parametrize("name", NAMES)
def test_batch_scheduler_matches_reference(name, mode,  # noqa: F811
                                           reference_norms, monkeypatch):
    S.test_batch_scheduler_matches_reference(name, mode, reference_norms,
                                             monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_pool_against_solo_digital(name):
    S.test_pool_against_solo_digital(name)


@pytest.mark.parametrize("which", ["serving-raceit", "serving", "digital"])
@pytest.mark.parametrize("name", NAMES)
def test_plan_explain(name, which):
    S.test_plan_explain(name, which)


@pytest.mark.parametrize("name", NAMES)
def test_paged_serving_refused_with_the_reference_reason(name):
    S.test_paged_serving_refused_with_the_reference_reason(name)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_crosses_over(tmp_path, name):
    S.test_checkpoint_crosses_over(tmp_path, name)


@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_from_the_pool(name, capsys):
    S.test_launcher_serves_from_the_pool(name, capsys)
