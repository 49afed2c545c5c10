"""The pipeline, the CLI, the job API and the batch runner (counterpart of audiotabs_tpu/runtime/)."""

from .storage import LocalStorage

__all__ = ["LocalStorage"]
