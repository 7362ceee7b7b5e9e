"""Scene assets of the composer's components (copies of `brax_tpu/composer/assets`)."""
