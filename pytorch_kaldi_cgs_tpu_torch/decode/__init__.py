"""Phone-loop HMM and Viterbi decoding."""
