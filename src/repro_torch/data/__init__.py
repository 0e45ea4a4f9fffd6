"""The synthetic, step-addressable LM data pipeline."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
