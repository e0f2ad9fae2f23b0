"""Input and output around the port: the training half of the reference's
fault injectors (:mod:`.chaos`)."""
