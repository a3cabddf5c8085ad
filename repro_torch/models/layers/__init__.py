"""Layer primitives of the port: common ops, GQA attention, dense FFN,
xLSTM's mLSTM and sLSTM blocks."""
