from repro_torch.core.database import SurrogateDB
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.functor import (SSlice, SymExpr, TensorFunctor, sym,
                                      tensor_functor)
from repro_torch.core.region import MLRegion, approx_ml
from repro_torch.core.tensor_map import TensorMap
