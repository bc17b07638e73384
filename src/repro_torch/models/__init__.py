"""Model substrate of the port (the dense, moe, ssm and hybrid families),
with the JAX parameters carried across by ``convert.from_jax_params``."""
from .convert import from_jax_params
from .layers import ParamTree, init_params
from .transformer import Model, build_model

__all__ = ["Model", "ParamTree", "build_model", "from_jax_params",
           "init_params"]
