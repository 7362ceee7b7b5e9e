"""The four-legged ant component, re-exported from the composer library
(a submission may re-export an existing component)."""

from brax_torch.composer.components import _ant as get_specs  # noqa: F401
