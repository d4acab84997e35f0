"""Operations and bytes counted from a configuration's shapes."""
