"""Operations and bytes from shapes: the kernels' least times (`kernels`)
and the model's FLOPs (`model`), kept with the benchmark so that a roofline
reads the same work whatever implements it."""
