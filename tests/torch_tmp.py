"""A fixture for the port's test modules that write large files (not a test
file). Imported into a module, it runs once around the module's tests and
then deletes what they wrote under pytest's base temporary directory:
checkpoints, weight files and artifacts of 100-1000 MB each, which pytest
would otherwise keep for its last three runs.

    from torch_tmp import drop_module_tmp  # noqa: F401
"""

import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def drop_module_tmp(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    yield
    for path in set(base.iterdir()) - before:
        if path.is_symlink():  # pytest's "<name>current" links
            path.unlink()
        else:
            shutil.rmtree(path, ignore_errors=True)
