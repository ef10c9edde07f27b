"""Device ops of the port; import the submodules directly."""
