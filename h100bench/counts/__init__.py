"""Operations and bytes of the kernels and of the models, from shapes and
masks alone, and the card's published peaks. Frozen here, where later
changes to the program cannot move them."""
