"""Model IO: the model directory (`save_model` / `load_model`) and the
exported whole-forward program (`export_program` / `load_program`)."""

from .serialize import load_model, save_model  # noqa: F401
from .export import enable_compilation_cache, export_program, load_program  # noqa: F401
