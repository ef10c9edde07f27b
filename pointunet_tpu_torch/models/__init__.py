"""Models of the port; import the submodules directly."""
