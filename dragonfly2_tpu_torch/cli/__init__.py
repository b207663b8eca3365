"""Composition roots (reference: cmd/).  ``scheduler.build`` wires the
serving scheduler."""
