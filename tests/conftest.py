import os

# Tests run on a virtual 8-device CPU mesh with f64 enabled so that results can
# be validated against the f64 Fortran reference semantics.
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8 "
                      + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REF = "/root/reference"
PI_MESH = os.path.join(REF, "test", "meshes", "pi")
SOUF_MESH = os.path.join(REF, "test", "meshes", "soufflet")


@pytest.fixture(scope="session")
def pi_mesh_path():
    return PI_MESH


@pytest.fixture(scope="session")
def souf_mesh_path():
    return SOUF_MESH


@pytest.fixture(scope="session")
def pi_mesh():
    from fesom2_tpu.mesh import build_mesh
    return build_mesh(PI_MESH, force_rotation=True, cyclic_length_deg=360.0)


@pytest.fixture(scope="session")
def souf_mesh():
    from fesom2_tpu.mesh import build_mesh
    return build_mesh(SOUF_MESH, cartesian=False, cyclic_length_deg=4.5)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long end-to-end golden-validation runs")
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")
