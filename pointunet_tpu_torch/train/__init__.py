"""Training loops of the port; import the submodules directly."""
