"""MoE core: router, token dispatch, MoE layer, upcycling."""
