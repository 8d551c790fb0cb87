"""Layers of the port: core, embed, attention, transformer, ode_block,
recurrent (import the submodules directly)."""
