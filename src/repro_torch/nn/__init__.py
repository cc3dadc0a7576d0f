from repro_torch.nn.layers import (CNN, MLP, Activation, Conv2D, Dense,
                                   Dropout, Flatten, LayerNorm, MaxPool2D,
                                   Sequential, from_spec)
from repro_torch.nn.serialize import (load_model, params_from_jax,
                                      qlayers_from_jax, save_model)
