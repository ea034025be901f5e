"""Weight converters into the port: Flax variables (``from_flax``) and
HuggingFace state_dicts (``torch_import``)."""
