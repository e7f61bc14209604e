"""Model definition: layers, GQA attention, block stacks, entry points."""
