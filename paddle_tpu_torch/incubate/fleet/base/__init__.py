"""reference: incubate/fleet/base/: the role makers."""
