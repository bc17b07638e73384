"""Model substrate of the port (every family of the JAX registry), with the
JAX parameters carried across by ``convert.from_jax_params`` and back by
``convert.to_jax_tree``."""
from .convert import from_jax_params, to_jax_tree
from .layers import ParamTree, init_params
from .transformer import Model, build_model

__all__ = ["Model", "ParamTree", "build_model", "from_jax_params",
           "init_params", "to_jax_tree"]
