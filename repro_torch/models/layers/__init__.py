"""Layer primitives of the port: common ops, GQA attention, MLA, Mamba,
the dense and MoE FFNs, xLSTM's mLSTM and sLSTM blocks."""
