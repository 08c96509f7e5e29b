"""Multi-tenant personalized-adapter serving (the deployment half of the
federation) — the port of ``repro/serve``: one shared frozen backbone and
a device slab of per-tenant LoRA adapters behind one decode step per mode.

  ServeConfig / ServeSession        — the serving loop (session.py)
  AdapterCache / CacheStats         — LRU slot paging over the slab (cache.py)
  export_adapters / serving_params  — fleet store -> serving handoff (export.py)
  make_decode_step / make_stacked_decode_step / make_prefill_step
                                    — the step factories (steps.py)
"""

from repro_torch.serve.adapters import canonicalize_row, gather_adapters, slab_init, slab_set_row
from repro_torch.serve.cache import AdapterCache, AdapterSource, CacheStats
from repro_torch.serve.export import export_adapters, serving_params
from repro_torch.serve.session import ServeConfig, ServeSession
from repro_torch.serve.steps import make_decode_step, make_prefill_step, make_stacked_decode_step

__all__ = [
    "ServeConfig",
    "ServeSession",
    "AdapterCache",
    "AdapterSource",
    "CacheStats",
    "export_adapters",
    "serving_params",
    "make_decode_step",
    "make_stacked_decode_step",
    "make_prefill_step",
    "slab_init",
    "slab_set_row",
    "gather_adapters",
    "canonicalize_row",
]
