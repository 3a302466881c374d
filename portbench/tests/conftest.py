import pytest

from .tiny import make_root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))
