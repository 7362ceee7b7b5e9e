"""Declarative multi-body scene composition, batch-first (counterpart of
`brax_tpu/composer`)."""

from brax_torch.composer.composer import ComponentEnv, Composer, create
from brax_torch.composer.components import register_component
