"""Hand-written Hopper kernels and the dispatch around them."""
