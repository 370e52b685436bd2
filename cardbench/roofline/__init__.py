"""Peak rates of the card and the least work of the computations read
against them."""
