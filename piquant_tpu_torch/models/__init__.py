"""Model definitions."""


def model_for(cfg):
    """The model module of a config (the reference engine's `_model_for`):
    `mla` for an MLAConfig, else `llama`.  The engine and speculation serve
    any module with init_kv_cache / prefill / decode_step whose cache holds
    batch on axis 1 of every leaf (llama.py's KVCache, mla.py's
    LatentKVCache)."""
    from piquant_tpu_torch.models import llama, mla

    return mla if isinstance(cfg, mla.MLAConfig) else llama
