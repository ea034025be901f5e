"""Weight converters into the port (``from_flax``)."""
