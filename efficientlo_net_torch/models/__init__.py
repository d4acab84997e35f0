"""Network layers and the PWCLO network."""
