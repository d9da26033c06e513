"""Preprocessing and planning: normalisation, cropping and padding
(:mod:`.tools`), dynamic flat fields (:mod:`.dffc`), the centre of rotation
(:mod:`.center`), the three-dictionary defaults (:mod:`.dicts`) and memory
estimates (:mod:`.memest`)."""
