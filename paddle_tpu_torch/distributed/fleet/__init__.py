"""`paddle_tpu/distributed/fleet/` of the port; so far only
`utils.recompute`."""
