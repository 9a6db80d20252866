"""Network modules of the BEVFusion serving path (NCHW ``nn.Module``s,
run ``channels_last`` on the card)."""
