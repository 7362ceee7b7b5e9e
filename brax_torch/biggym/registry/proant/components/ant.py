"""Submission wrapper of the composer's pro_ant component, at 4 legs (the
component's own default is 10)."""

from brax_torch.composer.components import _pro_ant


def get_specs(num_legs: int = 4):
    return _pro_ant(num_legs=num_legs)
