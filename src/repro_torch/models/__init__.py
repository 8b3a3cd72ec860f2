from .config import ModelConfig, ShapeConfig, SHAPES
from .model import (forward, init_cache, init_params, layer_specs, loss_fn,
                    serve_step)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "forward", "init_cache",
           "init_params", "layer_specs", "loss_fn", "serve_step"]
