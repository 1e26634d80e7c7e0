"""What both loops share: the port's configuration from a configuration
file, the tables' generator, device synchronisation and host copies."""

from __future__ import annotations

import gc

import torch

from kgbench.seeds import run_seed


def quiet(*args, **kwargs) -> None:
    pass


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in host memory, taken after the work queued on the
    current stream."""
    return x.detach().to("cpu", copy=True)


def port_config(config: dict, seed: int):
    from dglke_tpu_torch.config import KGEConfig
    return KGEConfig(**config["flags"], seed=run_seed(seed)).validate()


def init_state(model, seed: int):
    """The port's tables, drawn by its own init_state from a generator on
    the model's device seeded with the run's seed."""
    gen = torch.Generator(model.device)
    gen.manual_seed(run_seed(seed))
    return model.init_state(gen)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
