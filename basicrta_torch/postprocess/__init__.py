"""Post-processing: GMM clustering, votes and tau."""
