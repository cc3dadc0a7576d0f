"""Scientific mini-apps of the port: the paper's five benchmarks."""
from repro_torch.apps import binomial, bonds, minibude, miniweather, particlefilter

ALL_APPS = {
    "minibude": minibude,
    "binomial": binomial,
    "bonds": bonds,
    "miniweather": miniweather,
    "particlefilter": particlefilter,
}
