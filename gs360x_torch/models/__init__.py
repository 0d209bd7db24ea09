"""Models: the segmentation U-Net and its predictor (:mod:`.segmentation`),
the shipped weights' reader (:mod:`.weights`), instance separation on the
host (:mod:`.instances`) and the synthetic labelled corpus
(:mod:`.synthseg`)."""
