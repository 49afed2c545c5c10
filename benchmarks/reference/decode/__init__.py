"""Sequential decoders: Viterbi, DBN beats."""
