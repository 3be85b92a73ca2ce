"""build_model(cfg) — the model surface the serving stack drives.

Port of ``repro.models.model_zoo`` for every family of the JAX package:
``dense`` (olmo-1b, nemotron-4-15b, nemotron-4-340b, stablelm-12b),
``moe`` (mixtral-8x22b, llama4-maverick-400b-a17b), ``vlm``
(paligemma-3b) and ``encoder`` (hubert-xlarge), all four through
``models.transformer``, ``ssm``
(rwkv6-3b) and ``hybrid`` (recurrentgemma-9b, Griffin): ``init(seed,
device)``, ``prefill``, ``decode_step`` and ``init_cache``, and
``train_loss`` (every family; an MoE model's adds 0.01 of its router's
load-balance loss, as JAX's does); for the transformer also
``init_paged_cache`` and, behind the same eligibility gate as JAX (full
attention, no MoE, token inputs: no ``vlm`` or ``encoder`` arch passes
it), ``prefill_chunk``, ``prefill_suffix`` (the
prefix cache's suffix-only prefill) and the speculative verify entries
``prefill_chunk_logits`` and ``prefill_chunk_logits_multi`` (an MoE
arch's capacity-bounded routing is not reproducible per row, and
mixtral's window keeps a ring, so neither gets them: they serve static
or with solo whole-prompt admission). RWKV-6
keeps a constant-size recurrent state and has neither, as in JAX; nor
has Griffin, whose recurrent states and window-sized ring caches are
constant-size too.
"""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, rwkv6, transformer


def check_policy(cfg: ModelConfig, policy) -> None:
    """Refuse a precision policy for a family the JAX package serves
    unquantized only: rwkv6 (its packed (L, K, N) leaves meet ``.astype``
    in ``time_mix`` there) and the Griffin hybrid (the packed stacked
    ``rg_a_proj``/``rg_i_proj`` leaves meet ``.astype`` in
    ``_rglru_coeffs``, repro/models/griffin.py:128)."""
    if policy is None:
        return
    if cfg.family == "ssm":
        raise ValueError(f"{cfg.name}: the JAX package serves rwkv6 unquantized "
                         "only; no --policy/--quant")
    if cfg.family == "hybrid":
        raise ValueError(f"{cfg.name}: the JAX package serves griffin unquantized only "
                         "(repro/models/griffin.py:128 calls .astype on a packed "
                         "rg_a_proj); no --policy/--quant")


def build_model(cfg: ModelConfig) -> SimpleNamespace:
    if cfg.family == "ssm":
        mod = rwkv6
    elif cfg.family == "hybrid":
        mod = griffin
    elif cfg.family in ("dense", "moe", "vlm", "encoder"):
        mod = transformer
    else:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (the port runs "
                         "dense, moe, vlm, encoder, ssm and hybrid)")
    ns = SimpleNamespace(
        cfg=cfg,
        init=lambda seed=0, device=None: mod.init_params(cfg, seed, device),
        train_loss=lambda params, batch: mod.train_loss(params, cfg, batch),
        prefill=lambda params, batch: mod.prefill(params, cfg, batch),
        decode_step=lambda params, cache, tokens:
            mod.decode_step(params, cfg, cache, tokens),
        init_cache=lambda batch, seq_len, device=None:
            mod.init_cache(cfg, batch, seq_len, device),
    )
    if mod is transformer:
        ns.init_paged_cache = (
            lambda batch, num_blocks, block_size, max_blocks, device=None:
            mod.init_paged_cache(cfg, batch, num_blocks, block_size, max_blocks,
                                 device))
        if not cfg.attn_window and not cfg.moe_experts and cfg.frontend == "none":
            # Chunked prefill straight into the paged pool: the chunked ≡
            # whole-prompt contract needs full attention, per-row
            # reproducible routing and token inputs.
            ns.prefill_chunk = (lambda params, cache, batch:
                                mod.prefill_chunk(params, cfg, cache, batch))
            # Suffix-only prefill over pool-resident prefix blocks: the
            # prefix cache's warm ≡ cold contract needs the same gate.
            ns.prefill_suffix = (lambda params, batch:
                                 mod.prefill_suffix(params, cfg, batch))
            # Speculative verify: the chunk path with all-position logits.
            ns.prefill_chunk_logits = (lambda params, cache, batch:
                                       mod.prefill_chunk_logits(params, cfg, cache, batch))
            ns.prefill_chunk_logits_multi = (
                lambda params, cache, batch:
                mod.prefill_chunk_logits_multi(params, cfg, cache, batch))
    return ns
