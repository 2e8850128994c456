"""A fixture that points the port's persistent compile cache
(``repro_torch.core.sim.compile_cache``) at a temp dir of the test module,
so that tests neither read nor fill ``~/.cache/repro-sim-torch``. Import
it into a test module (``from _torch_sim_cache import
port_compile_cache``) and it applies to every test there; an explicitly
exported ``REPRO_TORCH_SIM_CACHE`` (``0`` included) is honored as is."""

import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def port_compile_cache(tmp_path_factory):
    from repro_torch.core.sim import compile_cache
    if compile_cache.ENV_VAR in os.environ:
        yield
        return
    os.environ[compile_cache.ENV_VAR] = str(
        tmp_path_factory.mktemp("repro-sim-torch"))
    compile_cache.reset_cache()
    try:
        yield
    finally:
        os.environ.pop(compile_cache.ENV_VAR, None)
        compile_cache.reset_cache()
