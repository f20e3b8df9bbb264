from .optim import adafactor, adamw, adamw8bit, make_optimizer

__all__ = ["adamw", "adamw8bit", "adafactor", "make_optimizer"]
