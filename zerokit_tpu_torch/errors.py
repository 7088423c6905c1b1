"""Typed error taxonomy, mirroring the reference's thiserror enums
(rln/src/error.rs, utils error types). Python exceptions keyed to the same
failure categories so API users can discriminate programmatically.
"""


class ZerokitError(Exception):
    """Base class for all framework errors."""


class UtilsError(ZerokitError):
    pass


class NonCanonicalFieldElement(UtilsError):
    """Byte string decodes to a value >= the field modulus."""


class InsufficientData(UtilsError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"expected {expected} bytes, got {actual}")
        self.expected = expected
        self.actual = actual


class ProtocolError(ZerokitError):
    pass


class ZeroUserMessageLimit(ProtocolError):
    pass


class InvalidMerkleProofLength(ProtocolError):
    pass


class InvalidMessageId(ProtocolError):
    pass


class EmptyMessageIds(ProtocolError):
    pass


class DuplicateMessageIds(ProtocolError):
    pass


class NoActiveSelectorUsed(ProtocolError):
    pass


class FieldLengthMismatch(ProtocolError):
    pass


class InvalidReadLen(ProtocolError):
    def __init__(self, read: int, total: int):
        super().__init__(f"read {read} of {total} bytes")
        self.read = read
        self.total = total


class UnknownVersionByte(ProtocolError):
    pass


class MessageModeMismatch(ProtocolError):
    pass


class SerializationError(ZerokitError):
    pass


class NonCanonicalBool(SerializationError):
    pass


class GenerateProofError(ZerokitError):
    pass


class VerifyProofError(ZerokitError):
    pass


class InvalidProof(VerifyProofError):
    pass


class InvalidRoot(VerifyProofError):
    pass


class InvalidSignal(VerifyProofError):
    pass


class RecoverSecretError(ZerokitError):
    pass


class ExternalNullifierMismatch(RecoverSecretError):
    pass


class NoMatchingNullifier(RecoverSecretError):
    pass


class DivisionByZero(RecoverSecretError):
    pass
