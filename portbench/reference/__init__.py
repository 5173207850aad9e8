"""The benchmark's plain reference: torch only, no part of the measured
package."""
