"""Layer primitives of the port: common ops, GQA attention, dense FFN."""
